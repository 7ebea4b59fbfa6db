#!/usr/bin/env python3
"""A/B timing of the port's Rabin-Karp scans on one NVIDIA GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Times the Rabin-Karp screens K5 ``rk_candidate_bsums``, K10b
``rk_candidate_nib``, K6 ``rk_candidate_pmask`` and K10c
``rk_candidate_bmask``, and the paths that run them, in each OTHER_CHECKOUT (a tree holding the port, for
example a parent commit unpacked with ``git archive``) against this
checkout, in turns X, this, this, X within one process.  Each checkout's
port is loaded under its own module name (the port imports itself only
relatively) and builds its kernels from its own ``csrc/``.  All run on the
same inputs: 256 MiB of ``gen_english`` seed 42 with the bench pattern
``"quick brown fox "``, a 509-byte slice of it and BASELINE config 2's
eight patterns (``chip_smoke.py`` (e)'s cases), and config 2's 1 GB text.

Before timing, every case's output in X, kernels and paths, must equal
this checkout's bit for bit.  Per turn: each kernel's device time per
launch from torch.profiler and its CUDA event time
(``chip_smoke.kernel_device_ms``, ``cuda_ms``); ``RabinKarpMatcher.run``
under sparse and 'nib' emission on the device-resident 256 MiB text and
config 2's ``RabinKarpMultiMatcher.run`` under sparse 'pselect' (K6),
'groups' (K10c) and 'nib' (K10b) on the device-resident 1 GB text
(host-clock passes ending in a synchronize, device time and events per
run from torch.profiler and its split by event name in the JSON, idle
share of the median pass).  Prints the card's name and power limit, one
line per measurement, and a JSON summary as the last line; exits 2 without
CUDA.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import chip_smoke as cs

HERE = Path(__file__).resolve().parent


def load_port(root: Path, alias: str):
    """The port package of checkout ``root`` as module ``alias``."""
    init = root / cs.PKG / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


class Port:
    """One checkout's port: its kernels built, its modules at hand."""

    def __init__(self, root: Path, alias: str):
        load_port(root, alias)
        sub = lambda name: importlib.import_module(f"{alias}.{name}")  # noqa: E731
        sub("utils.cuda_build").build_all()
        self.rk = sub("kernels.rk_roll")
        self.algos = sub("models.algorithms")
        self.multi = sub("models.multi")
        self.config = sub("utils.config")
        self.name = alias


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.base import (
        to_device,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
        tables,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
        gen_english,
        pad_to_multiple,
    )

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}")
    dev = torch.device("cuda")
    this = Port(HERE, "port_this")
    others = [Port(Path(p).resolve(), f"port_{i}") for i, p in enumerate(sys.argv[1:])]
    roots = {this.name: str(HERE), **{o.name: str(Path(p).resolve())
                                     for o, p in zip(others, sys.argv[1:])}}

    text = gen_english(256 * cs.MIB, seed=42)
    n = len(text)
    pat, p509 = b"quick brown fox ", text[123457 : 123457 + 509]
    padded = to_device(pad_to_multiple(np.frombuffer(text, np.uint8), 2 * cs.MIB), dev)
    region = padded.view(torch.int32)
    big = gen_english(cs.CONFIG2_BYTES, seed=2)
    nb = len(big)
    c2_pats = cs.config2_patterns(big)
    big_dev = to_device(pad_to_multiple(np.frombuffer(big, np.uint8), 2 * cs.MIB), dev)
    big_region = big_dev.view(torch.int32)
    base = int(tables.RK_BASE)
    u8 = lambda b: np.frombuffer(b, np.uint8)  # noqa: E731
    tgt = lambda pats: torch.tensor(  # noqa: E731
        [int(tables.rk_hash(u8(p), tables.rk_constants(len(p), base))) for p in pats],
        device=dev)
    t16, t509, t8 = tgt([pat]), tgt([p509]), tgt(cs.config2_patterns(text))
    tbig = tgt(c2_pats)
    cases = {  # name: (wrapper name, region, n_lim, targets, m)
        "K5 m=16": ("rk_candidate_bsums", region, n - 16, t16, 16),
        "K5 m=509": ("rk_candidate_bsums", region, n - 509, t509, 509),
        "K5 k=8 m=16": ("rk_candidate_bsums", region, n - 16, t8, 16),
        "K10b m=16": ("rk_candidate_nib", region, n - 16, t16, 16),
        "K10b m=509": ("rk_candidate_nib", region, n - 509, t509, 509),
        "K10b k=8 m=16": ("rk_candidate_nib", region, n - 16, t8, 16),
        "K10b 1 GB k=8 m=16": ("rk_candidate_nib", big_region, nb - 16, tbig, 16),
        "K6 k=8 m=16": ("rk_candidate_pmask", region, n - 16, t8, 16),
        "K6 1 GB k=8 m=16": ("rk_candidate_pmask", big_region, nb - 16, tbig, 16),
        "K10c k=8 m=16": ("rk_candidate_bmask", region, n - 16, t8, 16),
        "K10c 1 GB k=8 m=16": ("rk_candidate_bmask", big_region, nb - 16, tbig, 16),
    }

    def call(port, case):
        fn, words, lim, t, m = cases[case]
        return getattr(port.rk, fn)(words, lim, t, m, base)

    def paths_of(port) -> dict:
        """name: (matcher, padded text, length, iterations, profiled runs)."""
        cfg = port.config.MatchConfig()
        c2 = cfg.replace(capacity=524288, verify_capacity=524288)
        multi = port.multi.RabinKarpMultiMatcher
        return {
            "Rabin-Karp sparse run": (port.algos.RabinKarpMatcher(
                pat, cfg, device=dev), padded, n, 10, 10),
            "Rabin-Karp nib run": (port.algos.RabinKarpMatcher(
                pat, cfg.replace(emission="nib"), device=dev), padded, n, 10, 10),
            "config 2 pselect run": (multi(c2_pats, c2, device=dev), big_dev, nb, 3, 3),
            "config 2 groups run": (multi(c2_pats, c2.replace(multi_gather="groups"),
                                          device=dev), big_dev, nb, 3, 3),
            "config 2 nib run": (multi(c2_pats, c2.replace(emission="nib"), device=dev),
                                 big_dev, nb, 3, 3),
        }

    paths = {port.name: paths_of(port) for port in (this, *others)}

    def same(a, b) -> bool:
        """Tensors, numbers and nested sequences of them equal bit for bit."""
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    for o in others:
        for case in cases:
            a, b = call(o, case), call(this, case)
            assert same(a, b), f"{o.name} {case}"
            del a, b
            torch.cuda.empty_cache()
        for path, (mt, t, length, *_rest) in paths[o.name].items():
            mine = paths[this.name][path][0]
            assert same(mt.run(t, length), mine.run(t, length)), f"{o.name} {path}"
            torch.cuda.empty_cache()
        print(f"{roots[o.name]}: every case and path equals {roots[this.name]} bit for bit")

    def turn(port) -> dict:
        out = {}
        for case, (fn, *_rest) in cases.items():
            f = lambda: call(port, case)  # noqa: E731
            ev = cs.cuda_ms(f, 20)
            d, seen = cs.kernel_device_ms(f, 20, "rk_", getattr(port.rk, fn))
            out[case] = {"device_ms": d, "event_ms": ev, "recorded": seen}
            torch.cuda.empty_cache()
        for path, (mt, t, length, iters, runs) in paths[port.name].items():
            f = lambda: mt.run(t, length)  # noqa: E731
            wall = statistics.median(cs.host_ms(f, iters=iters, passes=3))
            d, events, split = cs.device_profile(f, runs=runs)
            out[path] = {"wall_ms": wall, "device_ms": d, "events": events,
                         "idle": 1 - d / wall, "split": split}
            torch.cuda.empty_cache()
        return out

    results = {}
    for o in others:
        for port in (o, this, this, o):
            r = turn(port)
            results.setdefault(port.name, []).append(r)
            for what, v in r.items():
                print(f"{roots[port.name]} {what}: "
                      + ", ".join(f"{k} {x:.4f}" for k, x in v.items() if k != "split")
                      + f" [{smi}]")
    print(smi)
    print(json.dumps({"card": smi, "roots": roots, "turns": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
