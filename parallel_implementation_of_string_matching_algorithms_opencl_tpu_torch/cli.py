"""Command line of the port (counterpart of the repo's ``cli.py``):

    python -m parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.cli \\
        <algo> <textfile> <pattern...> [options]

or ``tpumatch-torch`` once the package is installed.  The flags, their
defaults and the output are the reference's.  It runs on the card: without
CUDA it raises (``main(..., device="cpu")`` runs the kernels' plain
versions, as the tests do).

Execution modes: single device (default), ``--stream`` (a file in chunks,
with a resume manifest), ``--multihost`` (every process of a
``torch.distributed`` group takes a slice of the file; topology from
``TPUMATCH_NUM_PROCESSES`` / ``TPUMATCH_COORDINATOR`` /
``TPUMATCH_PROCESS_ID``; every process prints), and ``--distributed``
(sharded with halos, one rank per device: under ``torchrun
--nproc-per-node N -m ...cli ... --distributed`` the group is made from
the launcher's environment, NCCL on the card and gloo on the CPU, and only
rank 0 prints; without a launcher the world is one rank).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from . import match, match_distributed, match_multihost, match_multihost_streaming
from .models.base import resolve_device
from .parallel.mesh import rank_device
from .parallel.streaming import match_stream
from .utils.config import DEFAULT_CONFIG
from .utils.io import load_file


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpumatch-torch",
        description="CUDA exact string matching (naive/RK/KMP/BM)",
    )
    ap.add_argument("algo", help="naive | rabin_karp | kmp | boyer_moore (+aliases rk, bm)")
    ap.add_argument("textfile", help="path to the text corpus")
    ap.add_argument("pattern", nargs="+", help="pattern(s); multiple → multi-pattern run")
    ap.add_argument("--distributed", action="store_true", help="shard over the device mesh")
    ap.add_argument("--stream", action="store_true", help="stream file in chunks (unbounded size)")
    ap.add_argument("--chunk-mb", type=int, default=64, help="streaming chunk size (MiB)")
    ap.add_argument("--manifest", default=None, help="streaming resume manifest path")
    ap.add_argument("--resume", action="store_true", help="resume a streaming run from --manifest")
    ap.add_argument("--capacity", type=int, default=65536, help="offset buffer capacity")
    ap.add_argument("--count-only", action="store_true", help="print only the match count")
    ap.add_argument("--json", action="store_true", help="emit a JSON result object")
    ap.add_argument("--offsets", type=int, default=20, metavar="K", help="print first K offsets (default 20; -1 = all)")
    ap.add_argument("--hex-pattern", action="store_true", help="interpret pattern args as hex byte strings")
    ap.add_argument("--time", action="store_true", help="print wall time and bytes/s to stderr")
    ap.add_argument("--emission", default=None, choices=["sparse", "nib"],
                    help="offset emission mode (default: sparse — kernels "
                         "emit block sums only)")
    ap.add_argument("--bm-probes", default=None,
                    choices=["table_gs", "table_gs1", "table", "table_dyn",
                             "static"],
                    help="Boyer-Moore screen probe selection (default "
                         "table_gs: bad-char + good-suffix scored)")
    ap.add_argument("--kmp-long", default=None,
                    choices=["screen", "ripple"],
                    help="KMP execution for m>32 (default screen: K=1 "
                         "prefix-automaton candidate screen + full-m "
                         "verify; ripple: faithful K-word carry-rippled "
                         "automaton, m<=256)")
    ap.add_argument("--multi-gather", default=None,
                    choices=["pselect", "blocks", "groups"],
                    help="multi-pattern candidate extraction (default "
                         "pselect: each block verifies only its <=2 "
                         "hash-flagged patterns; blocks: all-pattern "
                         "verify, also the k>31 fallback; groups: "
                         "experimental 32-byte-group granularity)")
    ap.add_argument("--drain", action="store_true",
                    help="guarantee ALL offsets even past --capacity "
                         "(windowed re-extraction; all modes incl. "
                         "--stream, where overflowing chunks are re-read "
                         "and re-extracted)")
    ap.add_argument("--multihost", action="store_true",
                    help="run collectively across the torch.distributed "
                         "process group (topology from TPUMATCH_COORDINATOR "
                         "/ TPUMATCH_NUM_PROCESSES / TPUMATCH_PROCESS_ID); "
                         "combine with --stream for per-host chunked "
                         "streaming (config 5 scale)")
    return ap


def _init_from_launcher(device) -> None:
    """The process group of a ``torchrun`` launch (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on the rank's
    card (``device``, default ``cuda:LOCAL_RANK``), gloo for the CPU."""
    if device is None:
        device = rank_device(int(os.environ["RANK"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")


def main(argv=None, device="cuda") -> int:
    """Run one command line; returns the exit code.  ``device`` defaults
    to the card and raises without CUDA; ``device="cpu"`` runs the plain
    versions."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    # The sharded paths place each rank on its own card (LOCAL_RANK) unless
    # the caller named one.
    rank_dev = None if dev.type == "cuda" and dev.index is None else dev

    if args.hex_pattern:
        patterns = [bytes.fromhex(p) for p in args.pattern]
    else:
        patterns = [p.encode("utf-8") for p in args.pattern]
    many = patterns if len(patterns) > 1 else patterns[0]

    overrides = {"capacity": args.capacity}
    if args.emission:
        overrides["emission"] = args.emission
    if args.bm_probes:
        overrides["bm_probes"] = args.bm_probes
    if args.kmp_long:
        overrides["kmp_long"] = args.kmp_long
    if args.multi_gather:
        overrides["multi_gather"] = args.multi_gather

    sharded = args.distributed and not (args.stream or args.multihost)
    had_group = dist.is_initialized()
    if sharded and not had_group and "WORLD_SIZE" in os.environ:
        _init_from_launcher(rank_dev)
    try:
        t0 = time.perf_counter()
        if args.stream and args.multihost:
            out = match_multihost_streaming(
                args.textfile,
                many,
                algo=args.algo,
                config=DEFAULT_CONFIG.replace(**overrides),
                chunk_bytes=args.chunk_mb << 20,
                manifest_path=args.manifest,
                resume=args.resume,
                drain=args.drain,
                device=rank_dev,
            )
        elif args.stream:
            out = match_stream(
                args.textfile,
                many,
                algo=args.algo,
                config=DEFAULT_CONFIG.replace(**overrides),
                chunk_bytes=args.chunk_mb << 20,
                manifest_path=args.manifest,
                resume=args.resume,
                drain=args.drain,
                device=dev,
            )
        elif args.multihost:
            # As the reference: the first pattern only, no config overrides.
            out = match_multihost(args.textfile, patterns[0], algo=args.algo,
                                  drain=args.drain, device=rank_dev)
        elif args.distributed:
            out = match_distributed(load_file(args.textfile), many, algo=args.algo,
                                    drain=args.drain, device=rank_dev, **overrides)
        else:
            out = match(load_file(args.textfile), many, algo=args.algo,
                        drain=args.drain, device=dev, **overrides)
        results = out if isinstance(out, list) else [out]
        wall = time.perf_counter() - t0
        if sharded and dist.is_initialized() and dist.get_rank() != 0:
            return 0
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()

    if args.time:
        # As the reference: the first result's bytes times the results.
        nbytes = results[0].n * len(results)
        print(
            f"{wall:.3f}s  {nbytes / wall / 1e9:.2f} GB/s", file=sys.stderr
        )

    for pat, r in zip(patterns, results):
        if args.json:
            k = len(r.offsets) if args.offsets < 0 else min(args.offsets, len(r.offsets))
            print(
                json.dumps(
                    {
                        "algo": r.algo,
                        "pattern": pat.decode("utf-8", "replace"),
                        "n_bytes": r.n,
                        "count": r.count,
                        "overflow": r.overflow,
                        "offsets": [int(x) for x in r.offsets[:k]],
                        "wall_s": wall,
                    }
                )
            )
        elif args.count_only:
            print(r.count)
        else:
            show = r.offsets if args.offsets < 0 else r.offsets[: args.offsets]
            tail = "" if len(show) == r.count else f" ... (+{r.count - len(show)} more)"
            print(
                f"{r.algo}: pattern {pat!r}: {r.count} match(es)"
                + (f" at {[int(x) for x in show]}{tail}" if r.count else "")
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
