#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` with nvcc, then:

(a) holds each kernel (K1 ``screen_cand_bsums``, K2 ``naive_nib``) against
    its plain PyTorch version on the card, bit for bit, at the shapes the
    main path gives it (256 MiB corpora);
(b) drives ``match()`` (single-pattern Boyer-Moore, the defaults) on 256 MiB
    English, DNA and UTF-8 corpora against the pure-Python oracle;
(c) drives a match-dense case that must take the K2 rescan, against a
    numpy shifted-compare reference;
(d) checks that ``drain=True`` returns every offset past ``capacity``;
(e) times K1, K2 and their plain versions with CUDA events, and ``match``
    from host bytes and on a device-resident text.

The launch counters are zeroed before (b) and read after (d): each kernel
must have been launched by that main-path run.  Prints the card's name and
power limit, one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0);
without CUDA the script exits with code 2 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PKG = "parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch"
REF = "parallel_implementation_of_string_matching_algorithms_opencl_tpu"
MIB = 1 << 20


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def np_find_all(t, pat: bytes):
    """Every start of ``pat`` in uint8 array ``t`` by shifted compares."""
    import numpy as np

    m = len(pat)
    if len(t) < m:
        return np.empty(0, np.int64)
    hit = t[: len(t) - m + 1] == pat[0]
    for j in range(1, m):
        hit &= t[j : len(t) - m + 1 + j] == pat[j]
    return np.flatnonzero(hit)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events around the whole batch, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, passes: int = 3) -> list[float]:
    """Per-pass mean wall time of ``fn()`` in ms (host clock, ending in a
    device synchronize), after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    import numpy as np

    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
        MatchConfig,
        match,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
        swar,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
        BoyerMooreMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.base import (
        to_device,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
        cuda_build,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
        gen_dna,
        gen_english,
        gen_utf8,
        pad_to_multiple,
    )

    dev = torch.device("cuda")
    smi = nvidia_smi()
    card = f"[{smi}]"
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = cuda_build.build("swar")
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_log("swar").splitlines():
        if "ptxas info" in line:
            print(f"  {line.strip()}")

    # -- corpora (seeded, as bench.py and bench/matrix.py make them) -------
    t0 = time.perf_counter()
    eng = gen_english(256 * MIB, seed=42)
    rng = np.random.default_rng(4)
    dna = bytearray(gen_dna(256 * MIB, seed=4))
    dna_pat = rng.choice(np.frombuffer(b"ACGT", np.uint8), 16).tobytes()
    utf = bytearray(gen_utf8(256 * MIB * 10 // 21, seed=4))
    utf_pat = "\u4e00\u00e9\U0001F680 match \u4e7f\u00ff".encode()
    # Plants at the start, across 512 KiB tile seams, mid-text and at the
    # very end.
    for buf, pat in ((dna, dna_pat), (utf, utf_pat)):
        L = len(buf)
        for off in (0, 1000003, ((L // 2) & ~0x7FFFF) - 5, L // 3, L - len(pat)):
            buf[off : off + len(pat)] = pat
    corpora = {
        "english": (eng, b"quick brown fox "),
        "dna": (bytes(dna), dna_pat),
        "utf8": (bytes(utf), utf_pat),
    }
    dense_text, dense_pat = eng[: 64 * MIB], b"e "
    print(f"corpora: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {len(v[0])} B' for k, v in corpora.items())})")

    # -- (a) kernels vs plain versions on the card ---------------------------
    cfg = MatchConfig()
    errs = {"screen_cand_bsums": 0, "naive_nib": 0}
    shapes = []
    for name, (text, pat) in [*corpora.items(), ("dense", (dense_text, dense_pat))]:
        bm = BoyerMooreMatcher(pat, cfg, device=dev)
        n = len(text)
        padded = to_device(
            pad_to_multiple(np.frombuffer(text, np.uint8), 2 * MIB), dev
        )
        Nk, cut = swar.kernel_region(padded.numel(), bm.m, cfg.pallas_chunk_bytes)
        limit = min(n - bm.m, cut - 1)
        region = padded.view(torch.int32)[: Nk // 4]
        P, M, probes = bm.dev_tables["swar_p"], bm.swar_m, bm.dev_tables["probes"]
        bs_k = swar.screen_cand_bsums(region, limit, P, M, probes)
        bs_p = swar.screen_cand_bsums_plain(region, limit, P, M, probes)
        nib_k, bs2_k = swar.naive_nib(region, limit, P, M)
        nib_p, bs2_p = swar.naive_nib_plain(region, limit, P, M)
        torch.cuda.synchronize()
        e1 = int((bs_k - bs_p).abs().max())
        e2 = max(int((nib_k - nib_p).abs().max()), int((bs2_k - bs2_p).abs().max()))
        errs["screen_cand_bsums"] = max(errs["screen_cand_bsums"], e1)
        errs["naive_nib"] = max(errs["naive_nib"], e2)
        shapes.append(f"{name}: words {region.numel()}, m {bm.m}, nw {P.shape[1]}, "
                      f"probes {probes}, candidates {int(bs_k.sum())}, "
                      f"matches {int(bs2_k.sum())}, max_abs_err K1 {e1} K2 {e2}")
        assert torch.equal(bs_k, bs_p), f"K1 disagrees with plain on {name}"
        assert torch.equal(nib_k, nib_p) and torch.equal(bs2_k, bs2_p), (
            f"K2 disagrees with plain on {name}")
    print("(a) kernels bit-exact against their plain versions (tolerance 0):")
    for s in shapes:
        print(f"  {s}")

    # -- (b)-(d): the main path, with the launch counters zeroed ------------
    swar.screen_cand_bsums.launches = 0
    swar.naive_nib.launches = 0

    for name, (text, pat) in corpora.items():
        k1 = swar.screen_cand_bsums.launches
        r = match(text, pat)  # the defaults: boyer_moore, device="cuda"
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want and not r.overflow, (
            f"(b) {name}: count {r.count} vs {len(want)}")
        assert swar.screen_cand_bsums.launches > k1, f"(b) {name}: K1 not launched"
        print(f"(b) match {name} m={len(pat)}: count {r.count} == oracle, offsets equal")

    k2 = swar.naive_nib.launches
    r = match(dense_text, dense_pat)
    want = np_find_all(np.frombuffer(dense_text, np.uint8), dense_pat)
    cap = MatchConfig().capacity
    assert r.count == len(want) and r.overflow == (len(want) > cap), (
        f"(c) count {r.count} vs {len(want)}")
    assert np.array_equal(r.offsets, want[:cap]), "(c) offsets differ"
    assert swar.naive_nib.launches > k2, "(c) the dense case did not take K2"
    print(f"(c) dense m=2 on 64 MiB: count {r.count} == numpy reference, first "
          f"{cap} offsets equal, K2 launches {swar.naive_nib.launches - k2}")

    drain_text, drain_pat, drain_cap = eng[: 16 * MIB], b"the ", 16384
    r = match(drain_text, drain_pat, drain=True, capacity=drain_cap)
    want = np_find_all(np.frombuffer(drain_text, np.uint8), drain_pat)
    assert len(want) > drain_cap, "(d) drain case does not overflow"
    assert r.count == len(want) and not r.overflow
    assert np.array_equal(r.offsets, want), "(d) drained offsets differ"
    print(f"(d) drain capacity={drain_cap} on 16 MiB: all {r.count} offsets equal")

    launches = {"screen_cand_bsums": swar.screen_cand_bsums.launches,
                "naive_nib": swar.naive_nib.launches}
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched by the main path"
    print(f"main-path launches: {launches}")

    # -- (e) timings ---------------------------------------------------------
    text, pat = corpora["english"]
    n = len(text)
    bm = BoyerMooreMatcher(pat, cfg, device=dev)
    padded_np = pad_to_multiple(np.frombuffer(text, np.uint8), 2 * MIB)
    padded = to_device(padded_np, dev)
    Nk, cut = swar.kernel_region(padded.numel(), bm.m, cfg.pallas_chunk_bytes)
    limit = min(n - bm.m, cut - 1)
    region = padded.view(torch.int32)[: Nk // 4]
    P, M, probes = bm.dev_tables["swar_p"], bm.swar_m, bm.dev_tables["probes"]
    ms = {
        "screen_cand_bsums": cuda_ms(
            lambda: swar.screen_cand_bsums(region, limit, P, M, probes), 50),
        "naive_nib": cuda_ms(lambda: swar.naive_nib(region, limit, P, M), 50),
    }
    plain_ms = {
        "screen_cand_bsums": cuda_ms(
            lambda: swar.screen_cand_bsums_plain(region, limit, P, M, probes), 5),
        "naive_nib": cuda_ms(lambda: swar.naive_nib_plain(region, limit, P, M), 5),
    }
    for k in ms:
        print(f"(e) {k} 256 MiB english m=16: kernel {ms[k]:.4f} ms, plain "
              f"{plain_ms[k]:.4f} ms, {Nk / ms[k] / 1e6:.1f} GB/s kernel {card}")
    run_ms = host_ms(lambda: bm.run(padded, n), iters=10)
    print(f"(e) match device-resident 256 MiB english m=16: passes "
          f"{[round(x, 4) for x in run_ms]} ms, best {min(run_ms):.4f} ms = "
          f"{n / min(run_ms) / 1e6:.1f} GB/s {card}")
    host = host_ms(lambda: match(text, pat), iters=3)
    print(f"(e) match from host bytes 256 MiB english m=16: passes "
          f"{[round(x, 4) for x in host]} ms, best {min(host):.4f} ms = "
          f"{n / min(host) / 1e6:.1f} GB/s {card}")

    assert "jax" not in sys.modules, "the port imported jax"
    src = f"{PKG}/csrc/swar.cu"
    print(nvidia_smi())
    print(json.dumps({"kernels": [
        {"name": "screen_cand_bsums", "route": "cuda", "source": src,
         "replaces": f"{REF}/kernels/swar.py:477",
         "launches": launches["screen_cand_bsums"],
         "max_abs_err": errs["screen_cand_bsums"],
         "ms": ms["screen_cand_bsums"], "plain_ms": plain_ms["screen_cand_bsums"]},
        {"name": "naive_nib", "route": "cuda", "source": src,
         "replaces": f"{REF}/kernels/swar.py:386",
         "launches": launches["naive_nib"],
         "max_abs_err": errs["naive_nib"],
         "ms": ms["naive_nib"], "plain_ms": plain_ms["naive_nib"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
