#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` with nvcc (one process per
source, in parallel), then:

(a) holds each kernel against its plain PyTorch version on the card, bit
    for bit, at the shapes the main paths give it (256 MiB corpora): K1
    ``screen_cand_bsums``, K2 ``naive_nib`` and K3 ``naive_bsums`` on every
    corpus and on ragged regions (1, 31, 32, 33 and 97 blocks and one tile
    past a whole number of grid spans; each a fresh tensor that ends its
    allocation or starts off its 16-byte line; n_lim in the last block; K1
    under three probe layouts; K7/K8 ``screened_nib`` and ``screened_bsums``
    under the 'table_gs' and the 'table_dyn' probes, also against K2/K3,
    and K11a ``screen_cand_nibsums`` under both); K5 ``rk_candidate_bsums``, K10b
    ``rk_candidate_nib``, K6 ``rk_candidate_pmask`` and K10c
    ``rk_candidate_bmask`` on the same ragged lengths (m=16 and m=509 with
    one target, m=16 with k=8, 31 and 40, K6 up to k=31; regions that end
    their allocation or start 16 bytes into a buffer); K4 ``kmp_bsums`` and
    K10a ``kmp_nib`` on the same ragged lengths and placements at m = 1, 2,
    5, 16, 17, 31, 32, 33, 64, 255 and 256 (K = 1, 2, 8; a corpus slice and
    the same ending in NUL bytes, which matches at the region's end), and
    K9 (the composed step at m >= 5, compare-B per byte and composed at m
    <= 32) there against the plain versions and K4 / K10a; K4
    (K = 1 at m=16, the m=64
    screen on pattern[:32], K = 2 at m=64, K = 8 at m=256), K5
    ``rk_candidate_bsums`` (m=16, m=509, and k=8 targets) and K6
    ``rk_candidate_pmask`` (k=8 m=16 with BASELINE config 2's patterns,
    k=31 m=12, k=2 m=509, k=1 m=2; nonzero exactly where K5 is at k=8) on
    English and DNA; the decode ``decode_blocks`` against its plain version
    (a byte compare of the blocks it verifies, run on the card) at capacity
    0, 1, 4096 and 2**20, from K1's flags on every corpus, from K6's masks
    (k=8) and K5's sums (k=40) on English at 256 MiB and at 64 MiB + 5555 B (padded to
    4096, so the tail holds valid starts), and from K1's flags with a start
    planted in that tail;
(b) drives ``match()`` for every algorithm (the defaults: Boyer-Moore,
    then naive, KMP and Rabin-Karp) on 256 MiB English, DNA and UTF-8
    corpora against the pure-Python oracle; KMP also at m=4, 64 and 256,
    Rabin-Karp at m=509;
(c) drives a match-dense case through one decode (no K2 rescan), against
    a numpy shifted-compare reference;
(d) checks that ``drain=True`` returns every offset past ``capacity``, and
    that ``capacity=0`` is count-only for every algorithm (the oracle's
    count, no offsets, overflow when there is a match; ``drain=True``
    raises);
(f) drives ``match`` with pattern lists against the numpy reference:
    BASELINE config 2 at full size (1 GB English, 8 patterns, capacity
    2**19, default ``multi_gather='pselect'`` on K6), then at 256 MiB
    ``multi_gather='blocks'`` and k=64 (both on K5), a mixed-length
    Rabin-Karp list, a Boyer-Moore list and a drained list, and a dense
    m=2 list at 64 MiB that takes one decode and no K2 rescan;
(a') holds the kernels of the opt-in routes bit for bit against their plain
    versions and against the ported kernel with the same answer, at 256 MiB
    on English, DNA and UTF-8 and on the 64 MiB dense text: K7/K8
    ``screened_nib`` and ``screened_bsums`` (the 'table_gs' and the
    'table_dyn' probes) against K2/K3, K10a ``kmp_nib`` (m = the corpus
    pattern, 64 and 256: K = 1, 2, 8) against K2 and, for m <= 32, K4, and
    K10b ``rk_candidate_nib`` (k=1 at the corpus pattern and m=509, k=8)
    and K5 at the same cases against their plain versions, K10b's block
    sums against K5's, each true start among its candidates; K11a
    ``screen_cand_nibsums`` against its plain version under K2's own, K7's
    and K8's probes, and from its block sums the share of 512-byte blocks
    (warps of K2/K3 and K7/K8) with a screen hit;
    K9 (``kmp_bsums`` / ``kmp_nib`` with the composed-4 step at m = 5, 16,
    32, 33, 64 and 256, and with the compare-B lookup, per byte and
    composed, at m = 5, 16 and 32) against their plain versions and the
    per-byte K4 / K10a on the same four texts; K10c ``rk_candidate_bmask``
    (k=1 m=16, config 2's k=8 m=16, k=64 m=12) against its plain version
    and K5, each true start's group set;
(g) drives the opt-in routes through ``match()``: every algorithm with
    ``emission='nib'`` on the three 256 MiB corpora (oracle), KMP at m=64
    and 256 and Rabin-Karp at m=509, Boyer-Moore with ``bm_screen='fused'``,
    ``bm_probes='table_dyn'`` and ``'table_gs1'`` under sparse emission,
    the dense text under 'nib' for every algorithm and drained, and
    BASELINE config 2 at 1 GB under 'nib' (numpy reference); then
    ``multi_gather='groups'`` (config 2 at 1 GB, and at 256 MiB k=64, a
    mixed-length list and m=40, which takes 'blocks'), KMP with
    ``shift_and.STEP_PATH = "composed"`` (three corpora, m = corpus pattern,
    64, 256, sparse and 'nib'), compare-B through ``kmp_bsums`` /
    ``kmp_nib(..., pat_key=...)`` (m = 5, 16, 32) and Boyer-Moore with
    ``bm_variant='cursor'`` (256 MiB English, dense 64 MiB);
(h) holds the ``exp/`` prototypes' kernels at 256 MiB on English, DNA and
    UTF-8 (the corpus pattern, m=64 and m=509): K11a ``screen_cand_nibsums``
    against its plain version and, per block, between K2's count and 4x
    K1's; K11c (``exp.proto_kernels.proto_screen`` on the word and the
    block view) against K11a; K11b (``exp.screen_kernel_opt.run_variant``
    'v2' at R = 128, 256, 512) against K1; K11d ``gather_verify`` (cap_g
    1024, 2048, 4096, a list with fill ids, and one with the region's last
    group, repeated, unordered, negative and out-of-range ids) against its
    plain version and K2's nibble plane on the listed groups; then drives
    the path (``run_variant`` 'v1' and 'v2', ``exp.proto_kernels.gv_offsets``)
    against the oracle, and on the dense 64 MiB text, whose occupied groups
    outnumber cap_g, against the oracle on the listed groups;
(i) streams files through ``StreamingMatcher`` (pinned reader, side copy
    stream, resolver thread) at the default 64 MiB chunks, every result
    held against the numpy reference under the per-chunk capacity rule:
    BASELINE config 2's 1 GB corpus written to a temporary file (15 chunks,
    the last 60,475,904 bytes) with its 8 patterns under ``rabin_karp``
    (one K6 group) and a manifest, whose 8 journals must equal the
    reference; one 16-byte pattern under the list of all four algorithms;
    config 2 stopped after 5 chunks and resumed, its manifest and journals
    byte-equal to the first run's; ``drain=True`` on the dense 64 MiB text
    (m=2, capacity 65536); then the config 2 stream beside ``match`` from
    host bytes in alternating passes, the 16-byte pattern streamed under
    each algorithm alone, KMP's dense-DFA tail mask over a chunk's halo
    page, and one config 2 stream under torch.profiler (device busy time,
    idle share).  The files are deleted at the end of (k);
(j) drives the sharded paths on a one-rank NCCL process group (the group
    destroyed at its end; NCCL failing fails the script): BASELINE config 3
    (100 MB ``gen_english`` seed 3, KMP at m = 4, 16, 64 and 256, pattern
    ``text[5000:5000+m]``, capacity as bench/matrix.py's ``_cap``) through
    ``match_distributed`` under both ``dist_gather`` modes, the four
    algorithms at m=16 on the 256 MiB English corpus, config 2's 8 patterns
    through ``DistributedMultiMatcher``, a drain of the dense 64 MiB text
    at capacity 65536, ``match_multihost`` and ``match_multihost_streaming``
    on config 2's file, and the int64 gathers past 2**40 over NCCL, each
    against the numpy reference; then the walls of ``match_distributed``
    against ``match`` on the same bytes per config 3 pattern (the
    reference's ``dist_over_single`` at world 1) and the NCCL kernels'
    device time from torch.profiler;
(k) drives the port's command line (``…_torch/cli.py``): one in-process
    ``cli.main`` call (``bm`` with "quick brown fox " on the 256 MiB English
    corpus written to a file), then ``python -m …_torch.cli`` processes:
    each algorithm, config 2's 8 patterns under ``rk`` on its 1 GB file,
    ``--emission nib``, ``--stream`` (64 MiB chunks) with a manifest and
    then ``--resume``, ``--multihost`` and ``--stream --multihost`` at one
    process, ``--distributed`` without a launcher and under ``python -m
    torch.distributed.run --nproc-per-node 1`` (NCCL, seen in NCCL's log),
    and ``--capacity 256 --drain`` on the dense 64 MiB text; every result
    held against the numpy reference, every ``--time`` line printed;
(e) times every kernel and its plain version with CUDA events (K4 / K10a
    at m = 16, 64 and 256, K9 beside them, K10c beside K6; each also by its
    own device time per call from torch.profiler, its time in the JSON
    line, found by kernel name: K4, K10a and K9 ``kmp_warp_kernel``, K11d
    ``naive_groups_kernel``, its memset apart), ``match``
    per algorithm on a device-resident text (host clock, and device time
    and idle share from torch.profiler), sparse and 'nib' in alternating
    passes, and from host bytes, the KMP dense-DFA tail at m=509, K6,
    K10b and K10c at 256 MiB and 1 GB (there also by device time, against
    their bound and held against their plain versions), config 2's
    ``RabinKarpMultiMatcher.run`` on the device-resident 1 GB text (sparse
    'pselect', 'groups' and 'nib' in alternating passes) and from host
    bytes, the 'cursor' route on the device-resident 256 MiB text, K11a
    and K11d (each cap_g) beside their plain versions, and ``gv_offsets``
    against ``BoyerMooreMatcher.run`` on the device-resident 256 MiB
    English text in alternating passes, with their device time and events.

The launch counters are zeroed before (b) and read after (f), zeroed again
before (g) and read after it, K1's, K11a's and K11d's zeroed before
the path of (h) and read after it, and all zeroed again before the four
streams of (i) and read after them (K1, K3, K4, K5 and K6 must rise; the
JSON line's ``stream_launches``), and again before (j) and read after its
runs (the same five must rise; ``dist_launches``), and again just before
the in-process command line of (k) and read just after it (K1 must rise;
``cli_launches``): each kernel must have been launched by
the main-path run that exercises it.  Every printed line is flushed at
once, so a failure leaves the lines before it and its traceback on
stderr.  In a directory without the port (``chip_smoke.py`` alone) the
script exits 1 at its first import of the repo (the timers of
``…_torch/utils/profiling.py``, imported with the module), before printing
a line.  Prints the card's name and power
limit, one JSON line describing the kernels (with each one's bound: the
larger of its bytes over the card's 3.35 TB/s and its integer operations
over the INT32 instruction rate), and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0);
without CUDA the script exits with code 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# kernel_ab.py reads these timers from this module too.
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.profiling import (
    cuda_ms,
    device_busy,
    device_profile,
    host_ms,
    kernel_device_ms,
)

PKG = "parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch"
REF = "parallel_implementation_of_string_matching_algorithms_opencl_tpu"
MIB = 1 << 20
CONFIG2_BYTES = 1_000_000_000  # BASELINE config 2's 1 GB corpus
ALGOS = ("boyer_moore", "naive", "kmp", "rabin_karp")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# INT32 instruction rate: the 67 TFLOP/s fp32 peak counts an FMA as two
# operations on 128 lanes per SM; Hopper runs INT32 on 64 lanes per SM.
INT32_OPS_PER_S = 67e12 / 4
# Shared-memory lookups: 32 a clock per SM, at the clock that peak implies
# (67e12 / (132 SMs * 256 operations a clock)).
LOOKUPS_PER_S = 67e12 / 8


def bound(n_bytes: float, n_ops: float, n_lookups: float = 0) -> tuple[float, str]:
    """(ms, what bounds it): the least time for moving ``n_bytes`` through
    device memory, issuing ``n_ops`` integer operations and ``n_lookups``
    shared-memory lookups, the largest of the three."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / INT32_OPS_PER_S, n_lookups / LOOKUPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def step_path(path: str):
    """Run the Shift-AND wrappers on automaton step ``path`` (the module
    global ``shift_and.STEP_PATH``, as the reference selects it), restoring
    the previous step afterwards."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
        shift_and,
    )

    old, shift_and.STEP_PATH = shift_and.STEP_PATH, path
    try:
        yield
    finally:
        shift_and.STEP_PATH = old


def on_step(path: str, fn, *args, **kw):
    """``fn(*args, **kw)`` on automaton step ``path``."""
    with step_path(path):
        return fn(*args, **kw)


K9_NAMES = ("kmp_bsums_composed", "kmp_bsums_compare_b", "kmp_nib_composed",
            "kmp_nib_compare_b")


def group_mask(nib):
    """int32[Nw/128]: bit g of block b set when the nibble plane
    ``nib`` (int32[Nw]) has a bit in the block's 32-byte group g (K10c's
    function of the exact starts)."""
    import torch

    occ = (nib.view(-1, 16, 8) != 0).any(2).to(torch.int32)
    shifts = torch.arange(16, dtype=torch.int32, device=nib.device)
    return (occ << shifts).sum(1, dtype=torch.int32)


def popcount16(bm) -> int:
    """Set bits of the 16-bit masks in ``bm``."""
    return sum(int(((bm >> g) & 1).sum()) for g in range(16))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def np_find_all(t, pat: bytes):
    """Every start of ``pat`` in uint8 array ``t``, ascending: the starts
    of its first byte, narrowed by one byte compare per pattern byte."""
    import numpy as np

    m = len(pat)
    if len(t) < m:
        return np.empty(0, np.int64)
    idx = np.flatnonzero(t[: len(t) - m + 1] == pat[0])
    for j in range(1, m):
        idx = idx[t[idx + j] == pat[j]]
    return idx


def config2_patterns(text: bytes) -> list[bytes]:
    """BASELINE config 2's eight 16-byte patterns (bench/matrix.py:310-315):
    four phrases and four slices of the corpus itself."""
    n = len(text)
    return [b"quick brown fox ", b"lazy dog and cat", b"parallel device ",
            b"search algorithm", text[1000:1016], text[n // 2 : n // 2 + 16],
            text[n // 3 : n // 3 + 16], text[n - 4096 : n - 4080]]


def spread(text: bytes, k: int, m: int) -> list[bytes]:
    """k slices of m bytes at evenly spread offsets of ``text``."""
    step = (len(text) - m) // (k + 1)
    return [text[step * (i + 1) + 13 * i : step * (i + 1) + 13 * i + m]
            for i in range(k)]


RAGGED_PATTERNS = (b"e", b"quick brown fox ", b"ab\x00\x00",
                   bytes(range(1, 256)) + bytes(range(1, 255)))  # m = 509
KMP_RAGGED_M = (1, 2, 5, 16, 17, 31, 32, 33, 64, 255, 256)


def ragged_words(blocks: int, pat: bytes, tail: bytes | None = None):
    """tests/test_torch_cuda.py's ragged region: int32 words of ``blocks``
    512-byte blocks of seeded English, whole copies of ``pat`` planted and
    ``tail`` (default: its first two bytes) as the region's last bytes."""
    import numpy as np

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
        gen_english,
    )

    n = 512 * blocks
    data = bytearray(gen_english(n, seed=blocks + len(pat)))
    m = len(pat)
    end = 0
    for off in (0, n // 2 - 3, n - 512 - m // 2, n - 300, n - m - 7):
        if off >= end and off + m <= n:
            data[off : off + m] = pat
            end = off + m
    tail = pat[:2] if tail is None else tail
    data[n - len(tail) :] = tail
    return np.frombuffer(bytes(data), np.int32)


def placed(words, where: str, dev):
    """``words`` on the card as a fresh tensor: 'end', the last words of an
    allocation of whole 2 MiB pages (at least 10 MiB, mapped on its own by
    the caching allocator), nothing after them; 'lead' ('lead16'), one word
    (16 bytes) into a buffer of -1 words, which also follow it."""
    import torch

    n = words.size
    if where == "end":
        torch.cuda.empty_cache()
        total = max(-(-4 * n // (2 << 20)) * (2 << 20), 10 << 20) // 4
        buf = torch.full((total,), -1, dtype=torch.int32, device=dev)
        region = buf[total - n:]
    else:
        lead = 4 if where == "lead16" else 1
        buf = torch.full((n + lead + 128,), -1, dtype=torch.int32, device=dev)
        region = buf[lead : lead + n]
    region.copy_(torch.from_numpy(words.copy()))
    return region


def by_capacity(w, chunk: int, cap: int):
    """(offsets, overflow) a stream of ``chunk``-byte chunks returns for
    the ascending match starts ``w`` when each chunk keeps its first
    ``cap``."""
    import numpy as np

    ids = w // chunk
    rank = np.arange(len(w)) - np.searchsorted(ids, ids)
    return w[rank < cap], bool((rank >= cap).any())


def stream_phase(workdir: str, big: bytes, c2_pats, c2_cfg, c2_want, dense_text: bytes,
                 dense_pat: bytes, dense_cfg, kernels: dict, zero_counts, card: str,
                 chunk: int, device="cuda") -> dict:
    """Phase (i): ``StreamingMatcher`` over files in ``workdir`` (config 2's
    corpus ``big`` and ``dense_text``), every result held against the
    numpy reference (``c2_want``; the dense one made here) under the
    per-chunk capacity rule.  The launch counters are zeroed before the
    four cases and returned as read just after them; the timings and the
    profiler pass follow."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
        StreamingMatcher,
        match,
    )

    c2_path = os.path.join(workdir, "config2.bin")
    dense_path = os.path.join(workdir, "dense.bin")
    t0 = time.perf_counter()
    for path, data in ((c2_path, big), (dense_path, dense_text)):
        with open(path, "wb") as f:
            f.write(data)
    dense_want = np_find_all(np.frombuffer(dense_text, np.uint8), dense_pat)
    print(f"(i) files written ({len(big)} and {len(dense_text)} B) and the dense "
          f"reference made: {time.perf_counter() - t0:.1f} s")

    def hold(tag: str, rs, wants, cap: int, drained: bool = False) -> None:
        for r, w in zip(rs, wants, strict=True):
            offs, ovf = (w, False) if drained else by_capacity(w, chunk, cap)
            assert r.count == len(w), f"(i) {tag} {r.pattern!r}: count {r.count} vs {len(w)}"
            assert r.overflow == ovf, f"(i) {tag} {r.pattern!r}: overflow {r.overflow}"
            assert r.offsets.dtype == np.int64 and np.array_equal(r.offsets, offs), (
                f"(i) {tag} {r.pattern!r}: offsets")

    def stream(tag: str, pattern, algo, config, wants, path=c2_path, manifest=None,
               drained: bool = False, **kw):
        sm = StreamingMatcher(pattern, algo, config, chunk, manifest, device=device)
        t0 = time.perf_counter()
        rs = sm.match_file(path, drain=drained, **kw)
        dt = time.perf_counter() - t0
        rs = rs if isinstance(rs, list) else [rs]
        hold(tag, rs, wants, config.capacity, drained)
        # The bytes of the chunks this call streamed (a resumed run skips some).
        size = os.path.getsize(path)
        size -= (-(-size // chunk) - sm.last_stats["chunks"]) * chunk
        print(f"(i) {tag}: counts {[r.count for r in rs]} == numpy reference, offsets "
              f"equal{' (all, drained)' if drained else ''}, overflow "
              f"{[r.overflow for r in rs]}; wall {dt} s = {size / dt / 1e9} GB/s of "
              f"{sm.last_stats['chunks']} chunks; last_stats {sm.last_stats} {card}")
        return sm, rs

    zero_counts()
    man1 = os.path.join(workdir, "case1.json")
    sm1, _ = stream("case 1: config 2, k=8 m=16 rabin_karp, manifest", c2_pats,
                    "rabin_karp", c2_cfg, c2_want, manifest=man1)
    assert len(sm1._units) == 1 and sm1._units[0].multi, "(i) case 1 is not one group"
    for i, w in enumerate(c2_want):
        assert np.array_equal(np.fromfile(f"{man1}.offsets.{i}", "<i8"), w), (
            f"(i) case 1 journal {i}")
    algos = ["boyer_moore", "naive", "kmp", "rabin_karp"]
    stream(f"case 2: {c2_pats[0]!r} under {algos}", c2_pats[0], algos, c2_cfg,
           [c2_want[0]] * len(algos))

    class Stopped(StreamingMatcher):
        def _iter_chunks(self, *args):
            for item in super()._iter_chunks(*args):
                if item[0] >= 5:
                    return
                yield item

    man3 = os.path.join(workdir, "case3.json")
    Stopped(c2_pats, "rabin_karp", c2_cfg, chunk, man3, device=device).match_file(c2_path)
    with open(man3) as f:
        assert json.load(f)["next_chunk"] == 5, "(i) case 3 did not stop after 5 chunks"
    sm3, _ = stream("case 3: config 2 stopped after 5 chunks, then resume=True",
                    c2_pats, "rabin_karp", c2_cfg, c2_want, manifest=man3, resume=True)
    assert sm3.last_stats["chunks"] == -(-len(big) // chunk) - 5, "(i) case 3 chunks"
    for suffix in ["", *(f".offsets.{i}" for i in range(len(c2_pats)))]:
        with open(man1 + suffix, "rb") as f, open(man3 + suffix, "rb") as g:
            assert f.read() == g.read(), f"(i) case 3 {suffix or 'manifest'} differs"
    print("(i) case 3: manifest and 8 journals byte-equal to case 1's")
    assert len(dense_want) > 8 * dense_cfg.capacity, "(i) case 4 does not overflow"
    sm4, _ = stream(f"case 4: drain, dense {dense_pat!r} capacity {dense_cfg.capacity}",
                    dense_pat, "boyer_moore", dense_cfg, [dense_want], path=dense_path,
                    drained=True)
    assert sm4.last_stats["drained_slots"] >= 1, "(i) case 4 drained nothing"
    launches = {k: f.launches for k, f in kernels.items()}
    for k in ("screen_cand_bsums", "naive_bsums", "kmp_bsums", "rk_candidate_bsums",
              "rk_candidate_pmask", "decode_blocks"):
        assert launches[k] > 0, f"kernel {k} was not launched by the stream"
    print(f"streaming launches (i): {launches}")

    # Case 1 beside match() from host bytes, in alternating passes.
    walls = {"match_stream": [], "match from host bytes": []}
    for _ in range(2):
        t0 = time.perf_counter()
        rs = match(big, c2_pats, algo="rabin_karp", config=c2_cfg, device=device)
        walls["match from host bytes"].append(time.perf_counter() - t0)
        sm = StreamingMatcher(c2_pats, "rabin_karp", c2_cfg, chunk, device=device)
        t0 = time.perf_counter()
        sm.match_file(c2_path)
        walls["match_stream"].append(time.perf_counter() - t0)
        print(f"(i) case 1 pass: match_stream last_stats {sm.last_stats}")
    hold("case 1, match from host bytes", rs, c2_want, c2_cfg.capacity)
    for k, v in walls.items():
        print(f"(i) case 1 {k}, 1 GB k=8 m=16: passes {v} s, best {min(v)} s = "
              f"{len(big) / min(v) / 1e9} GB/s {card}")

    # Case 2's pattern under each algorithm alone, and the KMP tail's share:
    # the dense-DFA mask over [cut, _dev_len), the halo page and m - 1
    # bytes, once per chunk.
    for algo in algos:
        sm = StreamingMatcher(c2_pats[0], algo, c2_cfg, chunk, device=device)
        t0 = time.perf_counter()
        r = sm.match_file(c2_path)
        dt = time.perf_counter() - t0
        hold(f"{algo} alone", [r], c2_want[:1], c2_cfg.capacity)
        print(f"(i) {c2_pats[0]!r} under {algo} alone: wall {dt} s = "
              f"{len(big) / dt / 1e9} GB/s; last_stats {sm.last_stats} {card}")
    ks = StreamingMatcher(c2_pats[0], "kmp", c2_cfg, chunk, device=device)
    tail = torch.zeros(ks._dev_len - chunk + ks.m - 1, dtype=torch.uint8, device=device)
    tail_ms = host_ms(lambda: ks.matcher._mask(tail), iters=3, passes=2)
    print(f"(i) KMP m={ks.m} dense-DFA tail mask over {tail.numel()} B (a chunk's "
          f"halo page and m - 1 bytes): passes {tail_ms} ms {card}")

    sm = StreamingMatcher(c2_pats, "rabin_karp", c2_cfg, chunk, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs = sm.match_file(c2_path)
        wall = time.perf_counter() - t0
    hold("case 1 under the profiler", rs, c2_want, c2_cfg.capacity)
    busy, summed, events, split = device_busy(prof)
    parts = ", ".join(f"{name[:48]} {x} ms" for name, x in split.items())
    print(f"(i) case 1 under torch.profiler: wall {wall} s, {events} device events, "
          f"device busy {busy} ms (summed {summed} ms: {parts}), idle share "
          f"{1 - busy / 1e3 / wall} of the wall; last_stats {sm.last_stats} {card}")
    return launches


def c3_capacity(estimate: float) -> int:
    """bench/matrix.py:242 ``_cap``: the next power of two above twice the
    expected match count, at least 2**16."""
    return max(1 << 16, 1 << int(estimate * 2).bit_length())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(workdir: str, eng: bytes, eng_pat: bytes, big: bytes, c2_pats, c2_cfg,
               c2_want, dense_text: bytes, dense_pat: bytes, kernels: dict, zero_counts,
               card: str, c3_bytes: int = 100_000_000, backend: str = "nccl",
               device="cuda") -> dict:
    """Phase (j): the sharded paths on a one-rank process group (NCCL on the
    card; never another backend).  BASELINE config 3 (``c3_bytes`` of
    ``gen_english`` seed 3, KMP at m = 4, 16, 64 and 256, pattern
    ``text[5000:5000+m]``) through ``match_distributed`` under both
    ``dist_gather`` modes, the four algorithms on ``eng``, config 2 through
    ``DistributedMultiMatcher``, a drain of ``dense_text`` at capacity
    65536, ``match_multihost`` and ``match_multihost_streaming`` on config
    2's file in ``workdir``, and the int64 gathers past 2**40; every result
    held against the numpy reference.  The launch counters are zeroed before
    these and returned as read just after them; then the walls of
    ``match_distributed`` against ``match`` on the same bytes per config 3
    pattern, and the collectives' device time from torch.profiler."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
        MatchConfig,
        match,
        match_distributed,
        match_multihost,
        match_multihost_streaming,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel import (
        multihost,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.mesh import (
        make_data_mesh,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.streaming import (
        DEFAULT_CHUNK_BYTES,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
        gen_english,
    )

    t0 = time.perf_counter()
    c3 = gen_english(c3_bytes, seed=3)
    c3_np = np.frombuffer(c3, np.uint8)
    c3_pats = {m: c3[5000 : 5000 + m] for m in (4, 16, 64, 256)}
    c3_want = {m: np_find_all(c3_np, p) for m, p in c3_pats.items()}
    # bench/matrix.py:427-429: m=4 matches ~5e-3 of the bytes of English.
    c3_caps = {m: c3_capacity((8e-3 if m == 4 else 2e-4) * c3_bytes) for m in c3_pats}
    c3_cfg = {m: MatchConfig(capacity=c, verify_capacity=c) for m, c in c3_caps.items()}
    eng_want = np_find_all(np.frombuffer(eng, np.uint8), eng_pat)
    dense_want = np_find_all(np.frombuffer(dense_text, np.uint8), dense_pat)
    c2_path = os.path.join(workdir, "config2.bin")
    print(f"(j) config 3 corpus ({c3_bytes} B) and the numpy references: "
          f"{time.perf_counter() - t0:.1f} s")

    def hold(tag: str, r, want, cap: int, drained: bool = False) -> None:
        assert r.count == len(want), f"(j) {tag}: count {r.count} vs {len(want)}"
        offs, ovf = (want, False) if drained else (want[:cap], len(want) > cap)
        assert r.overflow == ovf, f"(j) {tag}: overflow {r.overflow}"
        assert r.offsets.dtype == np.int64 and np.array_equal(r.offsets, offs), (
            f"(j) {tag}: offsets")

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # init_process_group wants one
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1,
                            device_id=dev if backend == "nccl" else None)
    try:
        mesh = make_data_mesh(device=device)
        assert (mesh.world, dist.get_backend(mesh.group)) == (1, backend), "(j) group"
        t_run = time.perf_counter()
        zero_counts()
        for m, pat in c3_pats.items():
            for mode in ("count_sized", "fixed"):
                cfg = c3_cfg[m].replace(dist_gather=mode)
                t0 = time.perf_counter()
                r = match_distributed(c3, pat, algo="kmp", config=cfg, mesh=mesh)
                dt = time.perf_counter() - t0
                hold(f"config 3 m={m} {mode}", r, c3_want[m], cfg.capacity)
                assert r.algo == "kmp@mesh1", r.algo
                print(f"(j) config 3 KMP m={m} dist_gather={mode}: count {r.count} == numpy "
                      f"reference, offsets equal, capacity {cfg.capacity} ({dt:.2f} s from "
                      f"host bytes)")
        for algo in ALGOS:
            r = match_distributed(eng, eng_pat, algo=algo, mesh=mesh)
            hold(f"{algo} 256 MiB", r, eng_want, 65536)
            print(f"(j) {algo} m={len(eng_pat)} on {len(eng)} B English: count {r.count} == "
                  f"numpy reference, offsets equal")
        rs = match_distributed(big, c2_pats, algo="rabin_karp", config=c2_cfg, mesh=mesh)
        for p, r, w in zip(c2_pats, rs, c2_want, strict=True):
            hold(f"config 2 {p!r}", r, w, c2_cfg.capacity)
            assert r.algo == "rabin_karp_multi@mesh1", r.algo
        print(f"(j) config 2, {len(big)} B k=8 through DistributedMultiMatcher: counts "
              f"{[r.count for r in rs]} == numpy reference, offsets equal")
        dense_cfg = MatchConfig(capacity=65536)
        r = match_distributed(dense_text, dense_pat, config=dense_cfg, mesh=mesh,
                              drain=True)
        assert len(dense_want) > dense_cfg.capacity, "(j) the drain does not overflow"
        hold("drain", r, dense_want, dense_cfg.capacity, drained=True)
        print(f"(j) drain, dense {dense_pat!r} on {len(dense_text)} B capacity 65536: all "
              f"{r.count} offsets equal")
        r = match_multihost(c2_path, c2_pats[0], config=c2_cfg, device=device)
        hold("match_multihost", r, c2_want[0], c2_cfg.capacity)
        assert r.algo == "boyer_moore@hosts1", r.algo
        rs = match_multihost_streaming(c2_path, c2_pats, algo="rabin_karp", config=c2_cfg,
                                       device=device)
        for r, w in zip(rs, c2_want, strict=True):
            offs, ovf = by_capacity(w, DEFAULT_CHUNK_BYTES, c2_cfg.capacity)
            assert r.count == len(w) and r.overflow == ovf and np.array_equal(
                r.offsets, offs), f"(j) match_multihost_streaming {r.pattern!r}"
        print(f"(j) match_multihost ({c2_pats[0]!r}) and match_multihost_streaming (k=8) "
              f"on config 2's file: counts == numpy reference, offsets equal; tags "
              f"boyer_moore@hosts1, {rs[0].algo}")
        big_i = np.array([0, 2**40, 2**40 + 3, 99_999_999_999, 2**62 + 5, -1], np.int64)
        got = multihost.allgather_i64(big_i.reshape(2, 3), mesh)
        assert got.shape == (1, 2, 3) and np.array_equal(got[0], big_i.reshape(2, 3))
        assert np.array_equal(multihost.allgather_ragged_i64(big_i[:-1], mesh), big_i[:-1])
        assert multihost.allgather_ragged_i64(big_i[:0], mesh).size == 0
        print(f"(j) allgather_i64 / allgather_ragged_i64 over {backend}: values past "
              f"2**40 exact")
        launches = {k: f.launches for k, f in kernels.items()}
        print(f"sharded-path launches (j): {launches} ({time.perf_counter() - t_run:.1f} s "
              f"for the runs)")
        for k in ("screen_cand_bsums", "naive_bsums", "kmp_bsums", "rk_candidate_bsums",
                  "rk_candidate_pmask", "decode_blocks"):
            assert launches[k] > 0, f"kernel {k} was not launched by the sharded paths"

        # The wrapper's cost: match_distributed against match on the same
        # bytes, alternating, from host bytes.
        calls = {"match": functools.partial(match, device=device),
                 "match_distributed": functools.partial(match_distributed, mesh=mesh)}
        for m, pat in c3_pats.items():
            walls = {k: [] for k in calls}
            for _ in range(3):
                for k, fn in calls.items():
                    t0 = time.perf_counter()
                    fn(c3, pat, algo="kmp", config=c3_cfg[m])
                    walls[k].append(time.perf_counter() - t0)
            med = {k: statistics.median(v) for k, v in walls.items()}
            print(f"(j) config 3 m={m} from host bytes: match_distributed passes "
                  f"{walls['match_distributed']} s, match passes {walls['match']} s; "
                  f"dist_over_single {med['match_distributed'] / med['match']} (medians) "
                  f"{card}")
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        for mode in ("count_sized", "fixed"):
            cfg = c3_cfg[16].replace(dist_gather=mode)
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                match_distributed(c3, c3_pats[16], algo="kmp", config=cfg, mesh=mesh)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if dev.type == "cuda":
                busy, summed, events, split = device_busy(prof)
                coll = [e for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "nccl" in e.name.lower()]
                coll_ms = sum(e.time_range.elapsed_us() for e in coll) / 1e3
                names = sorted({e.name[:60] for e in coll})
                parts = ", ".join(f"{name[:48]} {x} ms" for name, x in split.items())
                print(f"(j) config 3 m=16 dist_gather={mode} under torch.profiler: wall "
                      f"{wall} s, {events} device events, busy {busy} ms (summed {summed} "
                      f"ms: {parts}); NCCL kernels {len(coll)}, {coll_ms} ms device "
                      f"({names}) {card}")
    finally:
        dist.destroy_process_group()
    return launches


def cli_phase(workdir: str, eng: bytes, eng_pat: bytes, c2_pats, c2_cap: int, c2_want,
              dense_text: bytes, dense_pat: bytes, kernels: dict, zero_counts,
              card: str, chunk: int) -> dict:
    """Phase (k): the port's command line on the card, over ``eng`` written
    to ``workdir`` and the files of (i) there (config 2's corpus and the
    dense text).  One in-process ``cli.main`` call (the default ``bm``),
    the launch counters zeroed just before it and returned as read just
    after it (K1 must rise); then ``python -m ...cli`` processes: each
    algorithm, config 2's 8 patterns under ``rk``, ``--emission nib``,
    ``--stream`` with a manifest and then ``--resume``, ``--multihost`` and
    ``--stream --multihost`` at one process, ``--distributed`` without a
    launcher and under ``torch.distributed.run --nproc-per-node 1`` (NCCL,
    seen in NCCL's own log) and ``--capacity 256 --drain`` on the dense
    text.  Every result is held against the numpy reference, every command
    runs with ``--time`` and its line is printed."""
    import numpy as np

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import cli

    eng_path = os.path.join(workdir, "english.bin")
    c2_path = os.path.join(workdir, "config2.bin")
    dense_path = os.path.join(workdir, "dense.bin")
    with open(eng_path, "wb") as f:
        f.write(eng)
    pat = eng_pat.decode()
    eng_want = np_find_all(np.frombuffer(eng, np.uint8), eng_pat)
    dense_want = np_find_all(np.frombuffer(dense_text, np.uint8), dense_pat)
    cap = 65536

    def hold(tag: str, rows, wants, algo: str, capacity: int = cap, by_chunk=False,
             drained=False) -> None:
        assert len(rows) == len(wants), f"(k) {tag}: {len(rows)} rows"
        for row, w in zip(rows, wants):
            if drained:
                offs, ovf = w, False
            elif by_chunk:
                offs, ovf = by_capacity(w, chunk, capacity)
            else:
                offs, ovf = w[:capacity], len(w) > capacity
            assert row["algo"] == algo, f"(k) {tag}: algo {row['algo']}"
            assert (row["count"], row["overflow"]) == (len(w), ovf), (
                f"(k) {tag} {row['pattern']!r}: count {row['count']} vs {len(w)}")
            assert np.array_equal(np.asarray(row["offsets"], np.int64), offs), (
                f"(k) {tag} {row['pattern']!r}: offsets")

    # In process, the counters zeroed just before and read just after.
    argv = ["bm", eng_path, pat, "--json", "--offsets", "-1", "--time"]
    out, err = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    assert rc == 0 and launches["screen_cand_bsums"] > 0, (
        f"(k) cli.main did not launch K1: {launches}")
    hold("in process bm", [json.loads(x) for x in out.getvalue().splitlines()],
         [eng_want], "boyer_moore")
    print(f"(k) cli.main({argv[:1] + argv[2:]}) in process on {len(eng)} B English: "
          f"count {len(eng_want)} == numpy reference, offsets equal; --time "
          f"{err.getvalue().strip()!r}, call wall {dt:.3f} s; launches {launches} {card}")

    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join([here, env.get("PYTHONPATH", "")])

    def run(tag: str, argv, launcher=(), extra_env=None) -> list:
        cmd = [sys.executable, *launcher, "-m", f"{PKG}.cli", *argv, "--json",
               "--offsets", "-1", "--time"]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=here,
                           env={**env, **(extra_env or {})})
        dt = time.perf_counter() - t0
        assert p.returncode == 0, f"(k) {tag}: rc {p.returncode}\n{p.stderr[-3000:]}"
        timing = [x for x in p.stderr.splitlines() if x.endswith("GB/s")]
        assert len(timing) == 1, f"(k) {tag}: --time lines {timing}"
        print(f"(k) {tag}: --time {timing[0]!r}, process wall {dt:.2f} s {card}")
        return [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]

    for algo in ALGOS:
        hold(algo, run(f"{algo} 256 MiB english", [algo, eng_path, pat]), [eng_want], algo)
    c2_args = ["rk", c2_path, *(p.decode() for p in c2_pats), "--capacity", str(c2_cap)]
    hold("config 2", run("config 2 rk k=8 1 GB", c2_args), c2_want, "rabin_karp_multi",
         capacity=c2_cap)
    hold("nib", run("kmp --emission nib 256 MiB english",
                    ["kmp", eng_path, pat, "--emission", "nib"]), [eng_want], "kmp")
    man = os.path.join(workdir, "cli.json")
    stream_args = [*c2_args[:-2], "--stream", "--chunk-mb", str(chunk >> 20),
                   "--manifest", man]
    first = run("config 2 rk --stream with a manifest", stream_args)
    hold("stream", first, c2_want, "rabin_karp@stream", by_chunk=True)
    with open(man) as f:
        assert json.load(f)["next_chunk"] == -(-os.path.getsize(c2_path) // chunk)
    again = run("config 2 rk --stream --resume", [*stream_args, "--resume"])
    assert [{**r, "wall_s": 0} for r in again] == [{**r, "wall_s": 0} for r in first], (
        "(k) the resumed stream differs")
    hold("multihost", run("bm --multihost, one process", ["bm", eng_path, pat,
                                                           "--multihost"]),
         [eng_want], "bm@hosts1")
    hold("stream multihost", run("kmp --stream --multihost, one process",
                                 ["kmp", eng_path, pat, "--stream", "--multihost"]),
         [eng_want], "kmp@stream", by_chunk=True)
    hold("distributed", run("naive --distributed, no launcher",
                            ["naive", eng_path, pat, "--distributed"]),
         [eng_want], "naive@mesh1")
    nccl_log = os.path.join(workdir, "nccl.%p.log")
    hold("torchrun", run("kmp --distributed under torch.distributed.run --nproc-per-node 1",
                         ["kmp", eng_path, pat, "--distributed"],
                         launcher=("-m", "torch.distributed.run", "--standalone",
                                   "--nproc-per-node", "1"),
                         extra_env={"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE": nccl_log}),
         [eng_want], "kmp@mesh1")
    logs = [os.path.join(workdir, x) for x in os.listdir(workdir) if x.startswith("nccl.")]
    assert logs and any("NCCL INFO" in open(x).read() for x in logs), (
        "(k) the launched rank made no NCCL communicator")
    hold("drain", run(f"bm --capacity 256 --drain, dense {dense_pat!r} 64 MiB",
                      ["bm", dense_path, dense_pat.decode(), "--capacity", "256",
                       "--drain"]),
         [dense_want], "boyer_moore", drained=True)
    print(f"(k) every command line equals the numpy reference ({len(dense_want)} drained "
          f"offsets at capacity 256); NCCL log {len(logs)} file(s)")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    import numpy as np

    from conformance.oracle import find_all as _find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
        MatchConfig,
        RabinKarpMultiMatcher,
        match,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp import (
        proto_kernels,
        screen_kernel_opt,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
        rk_roll,
        shift_and,
        swar,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
        BoyerMooreMatcher,
        KMPMatcher,
        NaiveMatcher,
        RabinKarpMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.base import (
        to_device,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
        kmp as kmp_ops,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.streaming import (
        DEFAULT_CHUNK_BYTES,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
        emit,
        reconstruct,
        tables,
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

    find_all = functools.lru_cache(maxsize=None)(_find_all)
    matchers = {"boyer_moore": BoyerMooreMatcher, "naive": NaiveMatcher,
                "kmp": KMPMatcher, "rabin_karp": RabinKarpMatcher}
    dev = torch.device("cuda")
    smi = nvidia_smi()
    card = f"[{smi}]"
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel)")
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

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
    # Longer patterns are slices of the corpus itself, so each occurs.
    long_pats = {name: {m: text[123457 : 123457 + m] for m in (64, 256, 509)}
                 for name, (text, _) in corpora.items()}
    dense_text, dense_pat = eng[: 64 * MIB], b"e "
    print(f"corpora: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {len(v[0])} B' for k, v in corpora.items())})")

    cfg = MatchConfig()
    padded_dev = {}

    def on_card(name: str, text: bytes):
        """The padded text on the card (2 MiB multiple: the KMP/RK tile)."""
        if name not in padded_dev:
            padded_dev[name] = to_device(
                pad_to_multiple(np.frombuffer(text, np.uint8), 2 * MIB), dev)
        return padded_dev[name]

    # -- (a) kernels vs plain versions on the card ---------------------------
    names = ("screen_cand_bsums", "naive_nib", "naive_bsums", "kmp_bsums",
             "rk_candidate_bsums", "rk_candidate_pmask", "screened_nib",
             "screened_bsums", "kmp_nib", "rk_candidate_nib", *K9_NAMES,
             "rk_candidate_bmask", "screen_cand_nibsums", "gather_verify")
    errs = dict.fromkeys(names, 0)
    lines = []

    def hold(kernel: str, what: str, got, want, quiet: bool = False) -> None:
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max(int((g - w).abs().max()) for g, w in zip(got, want))
        errs[kernel] = max(errs[kernel], e)
        if not quiet:
            lines.append(f"{kernel} {what}: max_abs_err {e}")
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (
            f"{kernel} disagrees on {what}")

    def hold_decode(what: str, words, flags, Ps, M, cut: int, n: int, m: int,
                    pmask: bool = False) -> None:
        """The decode against its plain version (a byte compare of the
        blocks it verifies, run on the card) at capacity 0, 1, 4096 and
        2**20: counts equal, and each pattern's first min(count, capacity)
        offsets."""
        for cap in (0, 1, 4096, 1 << 20):
            d = swar.decode_blocks.launches
            (gc, go), (wc, wo) = (
                swar.decode_blocks(words, flags, Ps, M, cut, n, m, cap, pmask),
                swar.decode_blocks_plain(words, flags, Ps, M, cut, n, m, cap, pmask))
            torch.cuda.synchronize()
            assert swar.decode_blocks.launches == d + 1, f"decode {what}: not launched"
            counts = wc.tolist()
            assert gc.tolist() == counts, f"decode {what} cap {cap}: counts"
            for p, c in enumerate(counts):
                w = min(c, cap)
                assert torch.equal(go[p, :w], wo[p, :w]), f"decode {what} cap {cap}: {p}"
        lines.append(f"decode_blocks {what}: counts {counts[:8]}{' ...' if len(counts) > 8 else ''}"
                     f" and offsets equal at capacity 0, 1, 4096, 2**20")

    all_corpora = [*corpora.items(), ("dense", (dense_text, dense_pat))]
    cand_words = {}
    for name, (text, pat) in all_corpora:
        bm = BoyerMooreMatcher(pat, cfg, device=dev)
        n = len(text)
        padded = on_card(name, text)
        Nk, cut = swar.kernel_region(padded.numel(), bm.m, cfg.pallas_chunk_bytes)
        limit = min(n - bm.m, cut - 1)
        region = padded.view(torch.int32)[: Nk // 4]
        P, M, probes = bm.dev_tables["swar_p"], bm.swar_m, bm.dev_tables["probes"]
        what = f"{name} m={bm.m} ({Nk} B)"
        bs1 = swar.screen_cand_bsums(region, limit, P, M, probes)
        hold("screen_cand_bsums", what, bs1,
             swar.screen_cand_bsums_plain(region, limit, P, M, probes))
        k2 = swar.naive_nib(region, limit, P, M)
        hold("naive_nib", what, k2, swar.naive_nib_plain(region, limit, P, M))
        bs3 = swar.naive_bsums(region, limit, P, M)
        hold("naive_bsums", what, bs3, swar.naive_bsums_plain(region, limit, P, M))
        cand_words[name] = int(bs1.sum())
        lines.append(f"  {name}: candidates {int(bs1.sum())}, matches {int(bs3.sum())}")
        # The decode from K1's flags, the tail [cut, N) in the padding.
        hold_decode(f"{what} from K1", padded.view(torch.int32), bs1, P[None], M, cut, n,
                    bm.m)
        # (a') K7 with the 'table_gs' probes, K8 with 'table_dyn''s.
        u = np.frombuffer(pat, np.uint8)
        for tag, table in (("K7", swar.probe_table(u, use_gs=True)),
                           ("K8", swar.probe_table(u))):
            lay = swar.static_probes_from_table(table)
            got = swar.screened_nib(region, limit, P, M, lay)
            hold("screened_nib", f"{what} {tag}", got,
                 swar.screened_nib_plain(region, limit, P, M, lay))
            hold("screened_nib", f"{what} {tag} vs K2", got, k2)
            got = swar.screened_bsums(region, limit, P, M, lay)
            hold("screened_bsums", f"{what} {tag}", got,
                 swar.screened_bsums_plain(region, limit, P, M, lay))
            hold("screened_bsums", f"{what} {tag} vs K3", got, bs3)
        # The warps of K2/K3 and K7/K8 that walk the verify chains: blocks
        # with a screen hit (K11a's block sums under the same probes, K11a
        # held against its plain version).
        shares = []
        for tag, lay in (("K2 own", swar.probe_indices(swar.mask_words(bm.m))),
                         ("K7 table_gs", swar.static_probes_from_table(
                             swar.probe_table(u, use_gs=True))),
                         ("K8 table_dyn", swar.static_probes_from_table(
                             swar.probe_table(u)))):
            bs11, tot = got = swar.screen_cand_nibsums(region, limit, P, M, lay)
            hold("screen_cand_nibsums", f"{what} {tag}", got,
                 swar.screen_cand_nibsums_plain(region, limit, P, M, lay))
            hit = int((bs11 > 0).sum())
            shares.append(f"{tag} {lay}: {hit} of {bs11.numel()} blocks "
                          f"({hit / bs11.numel():.4f}), {int(tot)} (word, alignment) hits")
        lines.append(f"  {name}: screen hits: {'; '.join(shares)}")
        del k2

    # The decode from K6's pattern masks and K5's block sums on English, the
    # text padded to 4096 only (so the tail holds valid starts), and K1's
    # flags of a text whose tail holds a planted start.
    eng_tail = eng[: 64 * MIB + 5555]
    for tag, pats, pmask in (("k=8 K6 masks", config2_patterns(eng), True),
                             ("k=40 K5 sums", spread(eng, 40, 12), False)):
        mm = RabinKarpMultiMatcher(pats, cfg, device=dev)
        for tname, text in (("256 MiB", eng), ("64 MiB + 5555 B", eng_tail)):
            padded = to_device(pad_to_multiple(np.frombuffer(text, np.uint8), 4096), dev)
            Nk, cut = shift_and.kernel_region(padded.numel(), mm.m, cfg.pallas_chunk_bytes)
            limit = min(len(text) - mm.m, cut - 1)
            scan = rk_roll.rk_candidate_pmask if pmask else rk_roll.rk_candidate_bsums
            flags = scan(padded.view(torch.int32)[: Nk // 4], limit, mm.dev_tables["hashes"],
                         mm.m, int(tables.RK_BASE))
            hold_decode(f"english {tname} {tag}", padded.view(torch.int32), flags,
                        mm.dev_tables["swar_ps"], mm.swar_m, cut, len(text), mm.m, pmask)
    tail_text = bytearray(eng_tail)
    tail_text[-40:-24] = b"quick brown fox "
    bm = BoyerMooreMatcher(b"quick brown fox ", cfg, device=dev)
    padded = to_device(pad_to_multiple(np.frombuffer(bytes(tail_text), np.uint8), 4096), dev)
    Nk, cut = swar.kernel_region(padded.numel(), bm.m, cfg.pallas_chunk_bytes)
    bs1 = swar.screen_cand_bsums(padded.view(torch.int32)[: Nk // 4],
                                 min(len(tail_text) - bm.m, cut - 1), bm.dev_tables["swar_p"],
                                 bm.swar_m, bm.dev_tables["probes"])
    hold_decode("english 64 MiB + 5555 B from K1, a start in the tail",
                padded.view(torch.int32), bs1, bm.dev_tables["swar_p"][None], bm.swar_m, cut,
                len(tail_text), bm.m)

    # K1-K3 walk 16 KiB tiles on a persistent grid: ragged regions of 1,
    # 31, 32, 33 and 97 blocks and of one tile more than SMs x c tiles
    # (c = 1..8 CTAs per SM: one of them is the grid's span plus one), each
    # a fresh tensor that ends its allocation or starts one word into a
    # buffer of -1 words, n_lim mid-way into the last block and at its last
    # byte, K1 under the 'static', 'table_gs' and 'table_gs1' probes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ragged = [1, 31, 32, 33, 97] + [32 * (sms * c + 1) for c in range(1, 9)]
    for pat in RAGGED_PATTERNS:
        u = np.frombuffer(pat, np.uint8)
        Pr, Mr = (torch.from_numpy(a).to(dev) for a in swar.pattern_words(u))
        layouts = {"static": swar.probe_indices(swar.mask_words(len(pat))),
                   "table_gs": swar.static_probes_from_table(swar.probe_table(u, use_gs=True)),
                   "table_gs1": swar.static_probes_from_table(
                       swar.probe_table(u, use_gs=True, single=True))}
        screened = {"table_gs": layouts["table_gs"],
                    "table_dyn": swar.static_probes_from_table(swar.probe_table(u))}
        held = matches = 0
        for blocks in ragged:
            host_words = ragged_words(blocks, pat)
            for where in ("end", "lead"):
                words = placed(host_words, where, dev)
                n_r = 4 * words.numel()
                for lim in (n_r - 512 + 137, n_r - 1):
                    what = f"ragged m={len(pat)} {blocks} blocks {where} n_lim={lim}"
                    for tag, lay in layouts.items():
                        hold("screen_cand_bsums", f"{what} {tag}",
                             swar.screen_cand_bsums(words, lim, Pr, Mr, lay),
                             swar.screen_cand_bsums_plain(words, lim, Pr, Mr, lay), quiet=True)
                    nib_p, bs_p = swar.naive_nib_plain(words, lim, Pr, Mr)
                    hold("naive_nib", what, swar.naive_nib(words, lim, Pr, Mr),
                         (nib_p, bs_p), quiet=True)
                    hold("naive_bsums", what, swar.naive_bsums(words, lim, Pr, Mr), bs_p,
                         quiet=True)
                    for tag in ("table_gs", "table_dyn"):
                        lay = screened[tag]
                        got = swar.screened_nib(words, lim, Pr, Mr, lay)
                        hold("screened_nib", f"{what} {tag}", got,
                             swar.screened_nib_plain(words, lim, Pr, Mr, lay), quiet=True)
                        hold("screened_nib", f"{what} {tag} vs K2", got, (nib_p, bs_p),
                             quiet=True)
                        got = swar.screened_bsums(words, lim, Pr, Mr, lay)
                        hold("screened_bsums", f"{what} {tag}", got,
                             swar.screened_bsums_plain(words, lim, Pr, Mr, lay), quiet=True)
                        hold("screened_bsums", f"{what} {tag} vs K3", got, bs_p, quiet=True)
                        hold("screen_cand_nibsums", f"{what} {tag}",
                             swar.screen_cand_nibsums(words, lim, Pr, Mr, lay),
                             swar.screen_cand_nibsums_plain(words, lim, Pr, Mr, lay),
                             quiet=True)
                    held += 15
                    matches += int(bs_p.sum())
                del words
        lines.append(f"ragged m={len(pat)}: K1 (3 layouts), K2, K3, K7/K8 nib and bsums (2 "
                     f"probe tables, also vs K2/K3), K11a (2 tables) on {len(ragged)} lengths "
                     f"({ragged[0]}..{ragged[-1]} blocks) x 2 placements x 2 n_lim: "
                     f"{held} holds, max_abs_err 0, {matches} matches in all")
    # K5, K10b, K6 and K10c (one warp-per-block kernel over a persistent
    # grid) at the same lengths and n_lim: m=16 and m=509 with one target,
    # m=16 with k=8, 31 (K6's widest mask) and 40 (past it: K6 not run)
    # targets (the pattern and slices of the region); each a fresh region
    # that ends its allocation or starts 16 bytes into a buffer of -1 words
    # (the RK wrappers refuse a start off its 16-byte line).
    base = int(tables.RK_BASE)
    for pat, k in ((b"quick brown fox ", 1), (RAGGED_PATTERNS[3], 1),
                   (b"quick brown fox ", 8), (b"quick brown fox ", 31),
                   (b"quick brown fox ", 40)):
        m = len(pat)
        c = tables.rk_constants(m, base)
        held = cands = 0
        for blocks in ragged:
            host_words = ragged_words(blocks, pat)
            raw = host_words.tobytes()
            pats = [pat] + [raw[(97 * i) % (len(raw) - m):][:m] for i in range(1, k)]
            tgt = torch.tensor([int(tables.rk_hash(np.frombuffer(q, np.uint8), c))
                                for q in pats], device=dev)
            for where in ("end", "lead16"):
                words = placed(host_words, where, dev)
                n_r = 4 * words.numel()
                for lim in (n_r - 512 + 137, n_r - 1):
                    what = f"ragged m={m} k={k} {blocks} blocks {where} n_lim={lim}"
                    nib_p, bs_p = rk_roll.rk_candidate_nib_plain(words, lim, tgt, m, base)
                    hold("rk_candidate_bsums", what,
                         rk_roll.rk_candidate_bsums(words, lim, tgt, m, base), bs_p, quiet=True)
                    hold("rk_candidate_nib", what,
                         rk_roll.rk_candidate_nib(words, lim, tgt, m, base), (nib_p, bs_p),
                         quiet=True)
                    if k <= rk_roll.MAX_PMASK_PATTERNS:
                        hold("rk_candidate_pmask", what,
                             rk_roll.rk_candidate_pmask(words, lim, tgt, m, base),
                             rk_roll.rk_candidate_pmask_plain(words, lim, tgt, m, base),
                             quiet=True)
                        held += 1
                    hold("rk_candidate_bmask", what,
                         rk_roll.rk_candidate_bmask(words, lim, tgt, m, base),
                         rk_roll.rk_candidate_bmask_plain(words, lim, tgt, m, base), quiet=True)
                    held += 3
                    cands += int(bs_p.sum())
                del words
        which = "K5, K10b, K6, K10c" if k <= rk_roll.MAX_PMASK_PATTERNS else "K5, K10b, K10c"
        lines.append(f"ragged RK m={m} k={k}: {which} on {len(ragged)} lengths x 2 "
                     f"placements (end, lead16) x 2 n_lim: {held} holds, max_abs_err 0, "
                     f"{cands} candidates in all")
    # K4 and K10a (a warp per block, the automaton carried across each
    # warp's span) at the same lengths and n_lim, K = 1, 2 and 8: a slice of
    # the English corpus and, for m >= 2, the same ending in NUL bytes, the
    # region ending in the pattern without them (at n_lim = its last byte a
    # start there matches the zeros past the region, in the plain versions
    # too); regions that end their allocation or start 16 bytes into a
    # buffer.  K9 on the same regions, against the plain versions and
    # K4 / K10a: the composed step (m >= 5) and compare-B per byte and
    # composed (m <= 32).
    for m in KMP_RAGGED_M:
        held = starts = 0
        k9 = ([("composed", None)] if m >= shift_and.COMPOSED_MIN_M else []) + (
            [("perbyte", True)] if m <= 32 else []) + (
            [("composed", True)] if shift_and.COMPOSED_MIN_M <= m <= 32 else [])
        head = b"e" if m == 1 else eng[777777 : 777777 + m]
        pats = [head] if m == 1 else [head, head[: m - min(2, m - 1)] + b"\x00" * min(2, m - 1)]
        for pat in pats:
            bt = torch.from_numpy(shift_and.b_table(np.frombuffer(pat, np.uint8))).to(dev)
            for blocks in ragged:
                host_words = ragged_words(blocks, pat, tail=pat.rstrip(b"\x00"))
                for where in ("end", "lead16"):
                    words = placed(host_words, where, dev)
                    n_r = 4 * words.numel()
                    for lim in (n_r - 512 + 137, n_r - 1):
                        what = f"ragged m={m} {pat[-2:]!r} {blocks} blocks {where} n_lim={lim}"
                        nib_p, bs_p = shift_and.kmp_nib_plain(words, lim, bt, m)
                        k4 = shift_and.kmp_bsums(words, lim, bt, m)
                        k10a = shift_and.kmp_nib(words, lim, bt, m)
                        hold("kmp_bsums", what, k4, bs_p, quiet=True)
                        hold("kmp_nib", what, k10a, (nib_p, bs_p), quiet=True)
                        held += 2
                        for path, cmp in k9:
                            key = pat if cmp else None
                            tag = f"{what} {path}{' compare-B' if cmp else ''}"
                            v = "compare_b" if cmp else "composed"
                            got = on_step(path, shift_and.kmp_bsums, words, lim, bt, m, pat_key=key)
                            hold(f"kmp_bsums_{v}", tag, got, bs_p, quiet=True)
                            hold(f"kmp_bsums_{v}", f"{tag} vs K4", got, k4, quiet=True)
                            got = on_step(path, shift_and.kmp_nib, words, lim, bt, m, pat_key=key)
                            hold(f"kmp_nib_{v}", tag, got, (nib_p, bs_p), quiet=True)
                            hold(f"kmp_nib_{v}", f"{tag} vs K10a", got, k10a, quiet=True)
                            held += 4
                        starts += int(bs_p.sum())
                    del words
        k9_tags = [f"{p}{' compare-B' if c else ''}" for p, c in k9]
        lines.append(f"ragged KMP m={m} K={shift_and.state_words(m)} ({len(pats)} patterns): "
                     f"K4, K10a, K9 {k9_tags} (also vs K4 / K10a) on {len(ragged)} lengths "
                     f"x 2 placements (end, lead16) x 2 n_lim: {held} holds, max_abs_err 0, "
                     f"{starts} starts in all")
    torch.cuda.empty_cache()

    for name in ("english", "dna"):
        text, pat16 = corpora[name]
        n = len(text)
        padded = on_card(name, text)
        p64, p256, p509 = (long_pats[name][m] for m in (64, 256, 509))
        for pat, head in ((pat16, pat16), (p64, p64[:32]), (p64, p64), (p256, p256)):
            mk = len(head)
            Nk, _ = shift_and.kernel_region(padded.numel(), len(pat),
                                            cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            bt = torch.from_numpy(shift_and.b_table(np.frombuffer(head, np.uint8))).to(dev)
            lim = min(n, Nk) - mk
            what = (f"{name} m={len(pat)} K={bt.shape[0]}"
                    f"{' screen' if mk < len(pat) else ''}")
            bs = shift_and.kmp_bsums(region, lim, bt, mk)
            hold("kmp_bsums", what, bs, shift_and.kmp_bsums_plain(region, lim, bt, mk))
            lines.append(f"  {what}: starts {int(bs.sum())}")
        base = int(tables.RK_BASE)
        for pat in (pat16, p509):
            m = len(pat)
            Nk, _ = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            tgt = torch.tensor([int(tables.rk_hash(np.frombuffer(pat, np.uint8)))],
                               device=dev)
            lim = min(n, Nk) - m
            bs = rk_roll.rk_candidate_bsums(region, lim, tgt, m, base)
            hold("rk_candidate_bsums", f"{name} m={m}", bs,
                 rk_roll.rk_candidate_bsums_plain(region, lim, tgt, m, base))
            lines.append(f"  {name} m={m}: hash candidates {int(bs.sum())}")
        # K6 with k targets; K5 with the same k = 8 (the 'blocks' route).
        for what, pats in (("k=8 m=16 config-2", config2_patterns(text)),
                           ("k=31 m=12", spread(text, 31, 12)),
                           ("k=2 m=509", spread(text, 2, 509)),
                           ("k=1 m=2", [text[777:779]])):
            m = len(pats[0])
            Nk, _ = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            c = tables.rk_constants(m, base)
            tgt = torch.tensor([int(tables.rk_hash(np.frombuffer(p, np.uint8), c))
                                for p in pats], device=dev)
            lim = min(n, Nk) - m
            pm = rk_roll.rk_candidate_pmask(region, lim, tgt, m, base)
            hold("rk_candidate_pmask", f"{name} {what}", pm,
                 rk_roll.rk_candidate_pmask_plain(region, lim, tgt, m, base))
            lines.append(f"  {name} {what}: blocks flagged {int((pm != 0).sum())}")
            if len(pats) == 8:
                bs = rk_roll.rk_candidate_bsums(region, lim, tgt, m, base)
                hold("rk_candidate_bsums", f"{name} {what} (blocks route)", bs,
                     rk_roll.rk_candidate_bsums_plain(region, lim, tgt, m, base))
                assert torch.equal(pm != 0, bs != 0), f"rk_candidate_pmask vs K5 on {what}"
                lines.append(f"  {name} {what}: hash candidates {int(bs.sum())}, K6 "
                             f"nonzero exactly where K5 is")
    # (a') K10a and K10b on every corpus, against their plain versions and
    # the ported kernels with the same answer.
    base = int(tables.RK_BASE)
    for name, (text, pat) in all_corpora:
        n = len(text)
        padded = on_card(name, text)
        for p in (pat, text[123457 : 123457 + 64], text[123457 : 123457 + 256]):
            m = len(p)
            Nk, cut = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            lim = min(n - m, cut - 1)
            u = np.frombuffer(p, np.uint8)
            bt = torch.from_numpy(shift_and.b_table(u)).to(dev)
            what = f"{name} m={m} K={bt.shape[0]}"
            got = shift_and.kmp_nib(region, lim, bt, m)
            hold("kmp_nib", what, got, shift_and.kmp_nib_plain(region, lim, bt, m))
            Pp, Mp = (torch.from_numpy(a).to(dev) for a in swar.pattern_words(u))
            hold("kmp_nib", f"{what} vs K2", got, swar.naive_nib(region, lim, Pp, Mp))
            if m <= 32:
                hold("kmp_nib", f"{what} vs K4", got[1],
                     shift_and.kmp_bsums(region, lim, bt, m))
            lines.append(f"  {what}: starts {int(got[1].sum())}")
        for p_what, pats in ((f"k=1 m={len(pat)}", [pat]),
                             ("k=1 m=509", [text[5000:5509]]),
                             ("k=8 m=16", spread(text, 8, 16))):
            m = len(pats[0])
            Nk, cut = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            lim = min(n - m, cut - 1)
            c = tables.rk_constants(m, base)
            tgt = torch.tensor([int(tables.rk_hash(np.frombuffer(q, np.uint8), c))
                                for q in pats], device=dev)
            what = f"{name} {p_what}"
            nib, bs = got = rk_roll.rk_candidate_nib(region, lim, tgt, m, base)
            plain = rk_roll.rk_candidate_nib_plain(region, lim, tgt, m, base)
            hold("rk_candidate_nib", what, got, plain)
            bs5 = rk_roll.rk_candidate_bsums(region, lim, tgt, m, base)
            hold("rk_candidate_bsums", what, bs5, plain[1])
            hold("rk_candidate_nib", f"{what} bs vs K5", bs, bs5)
            del plain
            for q in pats:
                Pq, Mq = (torch.from_numpy(a).to(dev)
                          for a in swar.pattern_words(np.frombuffer(q, np.uint8)))
                exact = swar.naive_nib(region, lim, Pq, Mq)[0]
                assert torch.equal(nib & exact, exact), (
                    f"rk_candidate_nib misses a true start on {what}")
            lines.append(f"  {what}: hash candidates {int(bs.sum())}, every true "
                         f"start among them")
    # (a') K9: the composed step at K = 1, 2, 8 and compare-B at K = 1 (per
    # byte and composed), against the plain versions and the per-byte
    # K4 / K10a.  K10c against its plain version and K5.
    for name, (text, _) in all_corpora:
        n = len(text)
        padded = on_card(name, text)
        for m in (5, 16, 32, 33, 64, 256):
            p = text[123457 : 123457 + m]
            Nk, cut = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            lim = min(n - m, cut - 1)
            bt = torch.from_numpy(shift_and.b_table(np.frombuffer(p, np.uint8))).to(dev)
            what = f"{name} m={m} K={bt.shape[0]}"
            plain = (shift_and.kmp_bsums_plain(region, lim, bt, m),
                     shift_and.kmp_nib_plain(region, lim, bt, m))
            with step_path("perbyte"):
                per_byte = (shift_and.kmp_bsums(region, lim, bt, m),
                            shift_and.kmp_nib(region, lim, bt, m))
            variants = [("composed", None)]
            if m <= 32:
                variants += [("perbyte", p), ("composed", p)]
            for path, key in variants:
                tag = f"{path}{' compare-B' if key else ''}"
                for i, (fn, k9) in enumerate(
                        ((shift_and.kmp_bsums, "kmp_bsums"), (shift_and.kmp_nib, "kmp_nib"))):
                    k9 = f"{k9}_{'compare_b' if key else 'composed'}"
                    got = on_step(path, fn, region, lim, bt, m, pat_key=key)
                    hold(k9, f"{what} {tag}", got, plain[i])
                    hold(k9, f"{what} {tag} vs {('K4', 'K10a')[i]}", got, per_byte[i])
            lines.append(f"  {what} K9 {[v[0] + (' compare-B' if v[1] else '') for v in variants]}: "
                         f"starts {int(per_byte[0].sum())}")
            del plain, per_byte
    for name in ("english", "dna"):
        text = corpora[name][0]
        n = len(text)
        padded = on_card(name, text)
        for what, pats in (("k=1 m=16", [corpora[name][1]]),
                           ("k=8 m=16 config-2", config2_patterns(text)),
                           ("k=64 m=12", spread(text, 60, 12)
                            + [f"P{i:02d}pattern64".encode() for i in range(4)])):
            m = len(pats[0])
            Nk, cut = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            region = padded.view(torch.int32)[: Nk // 4]
            lim = min(n - m, cut - 1)
            c = tables.rk_constants(m, base)
            tgt = torch.tensor([int(tables.rk_hash(np.frombuffer(q, np.uint8), c))
                                for q in pats], device=dev)
            bm = rk_roll.rk_candidate_bmask(region, lim, tgt, m, base)
            hold("rk_candidate_bmask", f"{name} {what}", bm,
                 rk_roll.rk_candidate_bmask_plain(region, lim, tgt, m, base))
            bs = rk_roll.rk_candidate_bsums(region, lim, tgt, m, base)
            assert torch.equal(bm != 0, bs != 0), f"rk_candidate_bmask vs K5 on {what}"
            true = torch.zeros_like(bm)
            for q in pats:
                Pq, Mq = (torch.from_numpy(a).to(dev)
                          for a in swar.pattern_words(np.frombuffer(q, np.uint8)))
                true |= group_mask(swar.naive_nib(region, lim, Pq, Mq)[0])
            assert torch.equal(bm & true, true), f"rk_candidate_bmask misses a start on {what}"
            lines.append(f"  {name} {what}: groups occupied {popcount16(bm)} in "
                         f"{int((bm != 0).sum())} blocks (K5's nonzero blocks), every true "
                         f"start's group among them")
    print("(a) kernels bit-exact against their plain versions (tolerance 0):")
    for s in lines:
        print(f"  {s}")

    # -- (b)-(d): the main paths, with the launch counters zeroed -----------
    kernels = {"screen_cand_bsums": swar.screen_cand_bsums,
               "naive_nib": swar.naive_nib, "naive_bsums": swar.naive_bsums,
               "kmp_bsums": shift_and.kmp_bsums,
               "rk_candidate_bsums": rk_roll.rk_candidate_bsums,
               "rk_candidate_pmask": rk_roll.rk_candidate_pmask,
               "screened_nib": swar.screened_nib,
               "screened_bsums": swar.screened_bsums,
               "kmp_nib": shift_and.kmp_nib,
               "rk_candidate_nib": rk_roll.rk_candidate_nib,
               "rk_candidate_bmask": rk_roll.rk_candidate_bmask,
               "decode_blocks": swar.decode_blocks}
    # K2 runs on the card only under emission='nib': the main path's dense
    # cases take the decode.
    opt_in = ("naive_nib", "screened_nib", "screened_bsums", "kmp_nib",
              "rk_candidate_nib", "rk_candidate_bmask")
    k9_wrappers = (shift_and.kmp_bsums, shift_and.kmp_nib)

    def zero_counts():
        for f in kernels.values():
            f.launches = 0
        for f in k9_wrappers:
            f.k9_launches = dict.fromkeys(f.k9_launches, 0)

    def k9_counts() -> dict:
        return {f"{f.__name__}_{v}": f.k9_launches[v]
                for f in k9_wrappers for v in ("composed", "compare_b")}
    scan_kernel = {"boyer_moore": swar.screen_cand_bsums,
                   "naive": swar.naive_bsums, "kmp": shift_and.kmp_bsums,
                   "rabin_karp": rk_roll.rk_candidate_bsums}
    zero_counts()

    def drive(tag: str, text: bytes, pat: bytes, algo: str, dense: bool = False,
              config=cfg, kernel=None, phase: str = "(b)"):
        """``match(text, pat)`` (device="cuda") against the oracle, or the
        numpy reference when ``dense``; ``kernel`` (default: the
        algorithm's sparse scan) must have been launched."""
        kernel = kernel or scan_kernel[algo]
        before = kernel.launches
        t0 = time.perf_counter()
        r = match(text, pat, algo=algo, config=config)
        dt = time.perf_counter() - t0
        if dense:
            want = np_find_all(np.frombuffer(text, np.uint8), pat)
            cap = config.capacity
            assert r.count == len(want) and r.overflow == (len(want) > cap), (
                f"{phase} {tag}: count {r.count} vs {len(want)}")
            assert np.array_equal(r.offsets, want[:cap]), f"{phase} {tag}: offsets"
        else:
            want = find_all(text, pat)
            assert (r.count == len(want) and r.offsets_list() == want
                    and not r.overflow), f"{phase} {tag}: count {r.count} vs {len(want)}"
        assert kernel.launches > before, f"{phase} {tag}: kernel not launched"
        print(f"{phase} match {tag} algo={algo} m={len(pat)}: count {r.count} == "
              f"{'numpy reference' if dense else 'oracle'}, offsets equal "
              f"({dt:.2f} s from host bytes)")

    for algo in ALGOS:
        for name, (text, pat) in corpora.items():
            drive(name, text, pat, algo)
    drive("english", eng, b"lazy", "kmp", dense=True)
    for m in (64, 256):
        drive("english", eng, long_pats["english"][m], "kmp")
    drive("english", eng, long_pats["english"][509], "rabin_karp")

    k2, d = swar.naive_nib.launches, swar.decode_blocks.launches
    r = match(dense_text, dense_pat)
    want = np_find_all(np.frombuffer(dense_text, np.uint8), dense_pat)
    cap = cfg.capacity
    assert r.count == len(want) and r.overflow == (len(want) > cap), (
        f"(c) count {r.count} vs {len(want)}")
    assert np.array_equal(r.offsets, want[:cap]), "(c) offsets differ"
    assert swar.decode_blocks.launches == d + 1 and swar.naive_nib.launches == k2, (
        "(c) the dense case did not take the decode alone")
    print(f"(c) dense m=2 on 64 MiB: count {r.count} == numpy reference, first "
          f"{cap} offsets equal, decode launches 1, K2 launches 0")

    drain_text, drain_pat, drain_cap = eng[: 16 * MIB], b"the ", 16384
    r = match(drain_text, drain_pat, drain=True, capacity=drain_cap)
    want = np_find_all(np.frombuffer(drain_text, np.uint8), drain_pat)
    assert len(want) > drain_cap, "(d) drain case does not overflow"
    assert r.count == len(want) and not r.overflow
    assert np.array_equal(r.offsets, want), "(d) drained offsets differ"
    print(f"(d) drain capacity={drain_cap} on 16 MiB: all {r.count} offsets equal")
    # capacity=0 is count-only, as in the reference.
    want = find_all(eng, b"quick brown fox ")
    for algo in ALGOS:
        before = scan_kernel[algo].launches
        r = match(eng, b"quick brown fox ", algo=algo, capacity=0)
        assert (r.count, len(r.offsets), r.overflow) == (len(want), 0, len(want) > 0), (
            f"(d) capacity=0 {algo}: count {r.count} vs {len(want)}")
        assert scan_kernel[algo].launches > before, f"(d) capacity=0 {algo}: no scan"
        print(f"(d) match english capacity=0 algo={algo}: count {r.count} == oracle, "
              f"no offsets, overflow {r.overflow}")
    try:
        match(drain_text, drain_pat, drain=True, capacity=0)
        raise AssertionError("(d) drain=True with capacity=0 did not raise")
    except ValueError as e:
        print(f"(d) drain=True with capacity=0 raises ValueError: {e}")

    # -- (f) pattern lists ---------------------------------------------------
    k5_f, k6_f = rk_roll.rk_candidate_bsums.launches, rk_roll.rk_candidate_pmask.launches

    def drive_many(tag: str, text: bytes, pats, want=None, phase: str = "(f)", **kw):
        """``match(text, pats, **kw)`` against the numpy reference: counts
        exact; offsets all of them (drain) or the first ``capacity``, with
        overflow set exactly when the count exceeds it."""
        t_np = np.frombuffer(text, np.uint8)
        if want is None:
            want = [np_find_all(t_np, p) for p in pats]
        cap = kw.get("config", cfg).capacity
        k2, k5, k6, k10, d = (swar.naive_nib.launches, rk_roll.rk_candidate_bsums.launches,
                              rk_roll.rk_candidate_pmask.launches,
                              rk_roll.rk_candidate_bmask.launches, swar.decode_blocks.launches)
        t0 = time.perf_counter()
        rs = match(text, pats, **kw)
        dt = time.perf_counter() - t0
        for p, r, w in zip(pats, rs, want):
            assert r.pattern == p and r.count == len(w), (
                f"{phase} {tag} {p!r}: count {r.count} vs {len(w)}")
            if kw.get("drain"):
                assert not r.overflow and np.array_equal(r.offsets, w), f"{phase} {tag} {p!r}"
            else:
                assert r.overflow == (len(w) > cap), f"{phase} {tag} {p!r}: overflow"
                assert np.array_equal(r.offsets, w[:cap]), f"{phase} {tag} {p!r}: offsets"
        print(f"{phase} {tag}: k={len(pats)} m={sorted({len(p) for p in pats})} "
              f"capacity {cap}: counts {[r.count for r in rs]} == numpy reference, "
              f"offsets equal{' (all, drained)' if kw.get('drain') else ''}, overflow "
              f"{[r.overflow for r in rs] if any(r.overflow for r in rs) else False}; "
              f"algos {sorted({r.algo for r in rs})}; launches K5 "
              f"{rk_roll.rk_candidate_bsums.launches - k5}, K6 "
              f"{rk_roll.rk_candidate_pmask.launches - k6}, K10c "
              f"{rk_roll.rk_candidate_bmask.launches - k10}, K2 "
              f"{swar.naive_nib.launches - k2}, decode {swar.decode_blocks.launches - d} "
              f"({dt:.2f} s from host bytes)")
        return rs

    # BASELINE config 2 at full size (bench/matrix.py:288-390).
    t0 = time.perf_counter()
    big = gen_english(CONFIG2_BYTES, seed=2)
    big_np = np.frombuffer(big, np.uint8)
    c2_pats = config2_patterns(big)
    c2_cap = 524288  # bench/matrix.py:316, _cap(2e-4 * n)
    c2_cfg = MatchConfig(capacity=c2_cap, verify_capacity=c2_cap)
    c2_want = [np_find_all(big_np, p) for p in c2_pats]
    print(f"(f) config 2 corpus and numpy reference: {time.perf_counter() - t0:.1f} s")
    k6 = rk_roll.rk_candidate_pmask.launches
    rs = drive_many("config 2, 1 GB English", big, c2_pats, want=c2_want,
                    algo="rabin_karp", config=c2_cfg)
    assert all(r.algo == "rabin_karp_multi" and not r.overflow for r in rs)
    assert rk_roll.rk_candidate_pmask.launches == k6 + 1, "(f) config 2 did not take K6"

    k5 = rk_roll.rk_candidate_bsums.launches
    drive_many("blocks, 256 MiB English", eng, config2_patterns(eng),
               algo="rabin_karp", config=cfg.replace(multi_gather="blocks"))
    k64 = spread(eng, 60, 12) + [f"P{i:02d}pattern64".encode() for i in range(4)]
    eng_np = np.frombuffer(eng, np.uint8)
    k64_want = [np_find_all(eng_np, p) for p in k64]
    drive_many("k=64, 256 MiB English", eng, k64, want=k64_want, algo="rabin_karp")
    assert rk_roll.rk_candidate_bsums.launches == k5 + 2, "(f) blocks/k=64 did not take K5"
    rs = drive_many("mixed lengths, 256 MiB English", eng,
                    [b"quick brown fox ", b"the ", b"lazy dog and cat", b"and ",
                     eng[5000:5509], b"fox ", b"e"], algo="rabin_karp")
    assert [r.algo for r in rs].count("rabin_karp") == 2  # the groups of one
    drive_many("Boyer-Moore list, 256 MiB English", eng,
               [b"quick brown fox ", b"the ", eng[5000:5509]])
    drive_many("drained list, 256 MiB English", eng, [b"the ", b"quick brown fox "],
               algo="rabin_karp", drain=True)
    k2, d = swar.naive_nib.launches, swar.decode_blocks.launches
    rs = drive_many("dense m=2, 64 MiB English", dense_text, [b"e ", b" t", b"th"],
                    algo="rabin_karp", config=cfg.replace(capacity=4096))
    assert all(r.overflow for r in rs) and swar.naive_nib.launches == k2 and (
        swar.decode_blocks.launches == d + 1), "(f) the dense list did not take one decode"
    assert rk_roll.rk_candidate_pmask.launches > k6_f and \
        rk_roll.rk_candidate_bsums.launches > k5_f, "(f) K5/K6 not launched"

    launches = {k: f.launches for k, f in kernels.items() if k not in opt_in}
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched by the main path"
    print(f"main-path launches (b)-(f): {launches}")

    # -- (g) the opt-in routes, with the launch counters zeroed -------------
    zero_counts()
    nib_cfg = cfg.replace(emission="nib")
    nib_kernel = {"boyer_moore": swar.screened_nib, "naive": swar.naive_nib,
                  "kmp": shift_and.kmp_nib, "rabin_karp": rk_roll.rk_candidate_nib}
    for algo in ALGOS:
        for name, (text, pat) in corpora.items():
            drive(f"{name} nib", text, pat, algo, config=nib_cfg,
                  kernel=nib_kernel[algo], phase="(g)")
    for m in (64, 256):
        drive("english nib", eng, long_pats["english"][m], "kmp", config=nib_cfg,
              kernel=shift_and.kmp_nib, phase="(g)")
    drive("english nib", eng, long_pats["english"][509], "rabin_karp",
          config=nib_cfg, kernel=rk_roll.rk_candidate_nib, phase="(g)")
    for kw in ({"bm_screen": "fused"}, {"bm_probes": "table_dyn"},
               {"bm_probes": "table_gs1"}):
        kernel = (swar.screen_cand_bsums if kw.get("bm_probes") == "table_gs1"
                  else swar.screened_bsums)
        for name, (text, pat) in corpora.items():
            drive(f"{name} {kw}", text, pat, "boyer_moore", config=cfg.replace(**kw),
                  kernel=kernel, phase="(g)")
    for algo in ALGOS:
        drive("dense 64 MiB nib", dense_text, dense_pat, algo, dense=True,
              config=nib_cfg, kernel=nib_kernel[algo], phase="(g)")
    drain_text = dense_text[: 16 * MIB]
    before = swar.screened_nib.launches
    r = match(drain_text, dense_pat, config=nib_cfg, drain=True)
    want = np_find_all(np.frombuffer(drain_text, np.uint8), dense_pat)
    assert len(want) > nib_cfg.capacity, "(g) drain case does not overflow"
    assert r.count == len(want) and not r.overflow
    assert np.array_equal(r.offsets, want), "(g) drained offsets differ"
    assert swar.screened_nib.launches > before
    print(f"(g) drain under nib, dense m=2 on 16 MiB: all {r.count} offsets equal, "
          f"K7 launches {swar.screened_nib.launches - before}")
    c2_nib = c2_cfg.replace(emission="nib")
    before = rk_roll.rk_candidate_nib.launches
    t0 = time.perf_counter()
    rs = match(big, c2_pats, algo="rabin_karp", config=c2_nib)
    dt = time.perf_counter() - t0
    for p, r, w in zip(c2_pats, rs, c2_want):
        assert r.algo == "rabin_karp_multi" and r.count == len(w), (
            f"(g) config 2 nib {p!r}: count {r.count} vs {len(w)}")
        assert not r.overflow and np.array_equal(r.offsets, w), f"(g) config 2 nib {p!r}"
    assert rk_roll.rk_candidate_nib.launches == before + 1
    print(f"(g) config 2 under nib, 1 GB English k=8: counts {[r.count for r in rs]} "
          f"== numpy reference, offsets equal, K10b launched once "
          f"({dt:.2f} s from host bytes)")

    # multi_gather='groups': config 2 at full size on K10c, then 256 MiB.
    groups_cfg = c2_cfg.replace(multi_gather="groups")
    before = rk_roll.rk_candidate_bmask.launches
    rs = drive_many("config 2 under groups, 1 GB English", big, c2_pats, want=c2_want,
                    algo="rabin_karp", config=groups_cfg, phase="(g)")
    assert all(r.algo == "rabin_karp_multi" and not r.overflow for r in rs)
    assert rk_roll.rk_candidate_bmask.launches == before + 1, "(g) config 2 groups: no K10c"
    g_cfg = cfg.replace(multi_gather="groups")
    before = rk_roll.rk_candidate_bmask.launches
    drive_many("groups k=64, 256 MiB English", eng, k64, want=k64_want, algo="rabin_karp",
               config=g_cfg, phase="(g)")
    drive_many("groups mixed lengths, 256 MiB English", eng,
               [b"quick brown fox ", b"the ", b"lazy dog and cat", b"and ",
                eng[5000:5509], b"fox ", b"e"], algo="rabin_karp", config=g_cfg, phase="(g)")
    assert rk_roll.rk_candidate_bmask.launches == before + 3, "(g) groups: K10c launches"
    k5 = rk_roll.rk_candidate_bsums.launches
    drive_many("groups m=40 (takes blocks), 256 MiB English", eng, spread(eng, 8, 40),
               algo="rabin_karp", config=g_cfg, phase="(g)")
    assert rk_roll.rk_candidate_bmask.launches == before + 3
    assert rk_roll.rk_candidate_bsums.launches == k5 + 1, "(g) groups m=40: not blocks"

    # KMP on the composed step, through match (the reference's STEP_PATH).
    with step_path("composed"):
        for name, (text, pat) in corpora.items():
            for p in (pat, long_pats[name][64], long_pats[name][256]):
                for e, kernel in (("sparse", shift_and.kmp_bsums),
                                  ("nib", shift_and.kmp_nib)):
                    before = kernel.k9_launches["composed"]
                    drive(f"{name} STEP_PATH=composed {e}", text, p, "kmp",
                          config=cfg.replace(emission=e), kernel=kernel, phase="(g)")
                    assert kernel.k9_launches["composed"] == before + 1

    # Compare-B, reached as in the reference: kmp_bsums / kmp_nib with
    # pat_key, each variant's block sums and nibble plane decoded against
    # the oracle over the kernel region.
    padded = on_card("english", eng)
    for m in (5, 16, 32):
        p = eng[123457 : 123457 + m]
        Nk, cut = shift_and.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
        region = padded.view(torch.int32)[: Nk // 4]
        lim = min(len(eng) - m, cut - 1)
        bt = torch.from_numpy(shift_and.b_table(np.frombuffer(p, np.uint8))).to(dev)
        want = [s0 for s0 in find_all(eng, p) if s0 <= lim]
        for path in ("perbyte", "composed"):
            with step_path(path):
                bs = shift_and.kmp_bsums(region, lim, bt, m, pat_key=p)
                nib, bs2 = shift_and.kmp_nib(region, lim, bt, m, pat_key=p)
            c, offs, _ = emit.nibble_to_matches(nib, bs2, len(want) + 1)
            assert int(bs.sum()) == c == len(want) and offs.tolist() == want, (
                f"(g) compare-B m={m} {path}")
        print(f"(g) compare-B m={m}, per byte and composed, 256 MiB english: "
              f"{len(want)} starts == oracle (block sums and decoded nibble plane)")

    # Boyer-Moore's lane-cursor skip loop (no kernel).
    cursor_cfg = cfg.replace(bm_variant="cursor")
    screens = (swar.screen_cand_bsums, swar.screened_bsums, swar.screened_nib)
    before = [f.launches for f in screens]
    for tag, text, pat, dense in (("english", eng, b"quick brown fox ", False),
                                  ("dense 64 MiB", dense_text, dense_pat, True)):
        t0 = time.perf_counter()
        r = match(text, pat, config=cursor_cfg)
        dt = time.perf_counter() - t0
        if dense:
            want = np_find_all(np.frombuffer(text, np.uint8), pat)
            assert r.count == len(want) and r.overflow == (len(want) > cfg.capacity)
            assert np.array_equal(r.offsets, want[: cfg.capacity]), f"(g) cursor {tag}"
        else:
            assert (r.count, r.offsets_list()) == (len(find_all(text, pat)),
                                                    find_all(text, pat)), f"(g) cursor {tag}"
        print(f"(g) match {tag} bm_variant=cursor m={len(pat)}: count {r.count} == "
              f"{'numpy reference' if dense else 'oracle'}, offsets equal "
              f"({dt:.2f} s from host bytes)")
    _, offs, _ = BoyerMooreMatcher(b"quick brown fox ", cursor_cfg, device=dev).run(
        on_card("english", eng), len(eng))
    assert offs.is_cuda, "(g) cursor offsets left the card"
    assert [f.launches for f in screens] == before, "(g) cursor launched a screen kernel"

    launches_g = {k: kernels[k].launches for k in opt_in}
    launches_g.update(k9_counts())
    for k, v in launches_g.items():
        assert v > 0, f"kernel {k} was not launched by the opt-in routes"
    launches.update(launches_g)
    print(f"opt-in-route launches (g): { {k: f.launches for k, f in kernels.items()} }, "
          f"K9 {k9_counts()}")

    # -- (h) the exp/ prototypes: K11a-d, then their path --------------------
    t_h = time.perf_counter()
    group_bytes = 4 * swar.GROUP_WORDS
    cap_gs = (1024, 2048, 4096)
    lines = []
    screens = {}  # (corpus, m): (K11a block sums, K1 block sums)
    for name, (text, pat) in corpora.items():
        n = len(text)
        padded = on_card(name, text)
        words = padded.view(torch.int32)
        nb8 = words.numel() // swar.GROUP_WORDS
        for p in (pat, long_pats[name][64], long_pats[name][509]):
            m = len(p)
            u = np.frombuffer(p, np.uint8)
            Pp, Mp = (torch.from_numpy(a).to(dev) for a in swar.pattern_words(u))
            lay = swar.static_probes_from_table(swar.probe_table(u, use_gs=True))
            Nk, cut = swar.kernel_region(padded.numel(), m, cfg.pallas_chunk_bytes)
            assert Nk == padded.numel(), "(h) the padded text is not whole tiles"
            lim = min(n - m, cut - 1)
            what = f"{name} m={m}"
            got = swar.screen_cand_nibsums(words, lim, Pp, Mp, lay)
            hold("screen_cand_nibsums", what, got,
                 swar.screen_cand_nibsums_plain(words, lim, Pp, Mp, lay))
            k1 = swar.screen_cand_bsums(words, lim, Pp, Mp, lay)
            k2_nib, k2_bs = swar.naive_nib(words, lim, Pp, Mp)
            assert bool((k2_bs <= got[0]).all()) and bool((got[0] <= 4 * k1).all()), (
                f"(h) K11a outside [K2, 4 K1] on {what}")
            screens[(name, m)] = (got[0], k1)
            for view, blocks in ((words.view(-1, 1024), False), (words.view(-1, 128), True)):
                c, b = proto_kernels.proto_screen(view, n, Pp, m, lay, from_blocks=blocks)
                hold("screen_cand_nibsums", f"{what} K11c {('words', 'blocks')[blocks]} "
                     f"vs K11a", (b, c), got)
            for R in (128, 256, 512):
                c, b = screen_kernel_opt.run_variant("v2", words, n, Pp, m, lay, R)
                # Blocks before the last of the Nk(R) region see the same words.
                same = b.numel() - (b.numel() < k1.numel())
                hold("screen_cand_bsums", f"{what} K11b R={R} vs K1", b[:same], k1[:same])
            rows = k2_nib.view(-1, 8, 128)
            lists = [(f"cap_g={c}", proto_kernels.group_ids(got[0], c)) for c in cap_gs]
            lists.append(("fill ids", torch.tensor([0, 5, 127, 128, nb8, nb8 - 1, nb8],
                                                   dtype=torch.int32, device=dev)))
            # The region's last group (its halo past the text) first and
            # again, repeated and unordered ids, negative and out-of-range
            # ids, the fill id.
            lists.append(("edge ids", torch.tensor(
                [nb8 - 1, -1, 300, 300, 7, nb8, nb8 + 9, -4096, 6, 8, nb8 - 1],
                dtype=torch.int32, device=dev)))
            for tag, g8 in lists:
                gv = swar.gather_verify(words, g8, n - m, Pp, Mp)
                hold("gather_verify", f"{what} {tag}", gv,
                     swar.gather_verify_plain(words, g8, n - m, Pp, Mp))
                listed = (g8 >= 0) & (g8 < nb8)
                want = torch.zeros_like(gv[0])
                want[listed] = rows[g8[listed].long()]
                hold("gather_verify", f"{what} {tag} vs K2 rows", gv[0], want)
            occupied = int((got[0].view(-1, 8).sum(1) > 0).sum())
            lines.append(f"  {what}: candidates {int(got[1])} (K1 words {int(k1.sum())}, "
                         f"K2 starts {int(k2_bs.sum())}) in {occupied} groups")
            del k2_nib, rows
    print("(h) exp/ kernels bit-exact (tolerance 0): K11a vs plain, K11c (both views) "
          "vs K11a, K11b (R=128/256/512) vs K1, K11d vs plain and K2's rows "
          "(cap_g 1024/2048/4096, a list with fill ids and one with the last group, "
          "repeated, unordered, negative and out-of-range ids):")
    for s in lines:
        print(f"  {s}")

    # The path: run_variant (V1, V2-V4) and gv_offsets, counters zeroed.
    h_kernels = {"screen_cand_bsums": swar.screen_cand_bsums,
                 "screen_cand_nibsums": swar.screen_cand_nibsums,
                 "gather_verify": swar.gather_verify}
    for f in h_kernels.values():
        f.launches = 0
    capacity = cfg.capacity

    def check_gv(tag: str, text: bytes, p: bytes, dense: bool = False) -> bool:
        """``gv_offsets`` at cap_g 4096 against the oracle; when the
        occupied groups outnumber cap_g, against the oracle's starts in the
        listed groups (count also against K2's block sums there).  Returns
        whether every group was listed."""
        n, m = len(text), len(p)
        padded = on_card(tag, text)
        words = padded.view(torch.int32)
        u = np.frombuffer(p, np.uint8)
        Pp = torch.from_numpy(swar.pattern_words(u)[0]).to(dev)
        lay = swar.static_probes_from_table(swar.probe_table(u, use_gs=True))
        cap_g = cap_gs[-1]
        count, offs, overflow = proto_kernels.gv_offsets(words, n, Pp, m, lay, cap_g,
                                                         capacity)
        want = (np_find_all(np.frombuffer(text, np.uint8), p).tolist() if dense
                else find_all(text, p))
        bs = proto_kernels.proto_screen(words.view(-1, 1024), n, Pp, m, lay)[1]
        occupied = int((bs.view(-1, 8).sum(1) > 0).sum())
        whole = occupied <= cap_g
        if not whole:
            g8 = proto_kernels.group_ids(bs, cap_g)
            listed = set(g8.tolist())
            want = [s0 for s0 in want if s0 // group_bytes in listed]
            k2_bs = swar.naive_nib(words, n - m, Pp,
                                   torch.from_numpy(swar.mask_words(m)).to(dev))[1]
            assert count == int(k2_bs.view(-1, 8)[g8.long()].sum()), (
                f"(h) gv_offsets {tag} m={m}: count vs K2 on the listed groups")
        assert count == len(want) and overflow == (len(want) > capacity), (
            f"(h) gv_offsets {tag} m={m}: count {count} vs {len(want)}")
        assert offs.tolist() == want[:capacity], f"(h) gv_offsets {tag} m={m}: offsets"
        print(f"(h) gv_offsets {tag} m={m} cap_g={cap_g}: {occupied} occupied groups, "
              f"count {count} == oracle{'' if whole else ' on the listed groups'}, "
              f"first {min(count, capacity)} offsets equal, overflow {overflow}")
        return whole

    for name, (text, pat) in corpora.items():
        n = len(text)
        words = on_card(name, text).view(torch.int32)
        for p in (pat, long_pats[name][64], long_pats[name][509]):
            m = len(p)
            u = np.frombuffer(p, np.uint8)
            Pp = torch.from_numpy(swar.pattern_words(u)[0]).to(dev)
            lay = swar.static_probes_from_table(swar.probe_table(u, use_gs=True))
            k11a, k1 = screens[(name, m)]
            assert torch.equal(screen_kernel_opt.run_variant("v1", words, n, Pp, m, lay)[1],
                               k11a), f"(h) run_variant v1 {name} m={m}"
            for R in (128, 256, 512):
                b = screen_kernel_opt.run_variant("v2", words, n, Pp, m, lay, R)[1]
                same = b.numel() - (b.numel() < k1.numel())
                assert torch.equal(b[:same], k1[:same]), f"(h) run_variant v2 R={R} {name}"
            whole = check_gv(name, text, p)
            assert whole or name != "english" or m != len(pat), (
                "(h) English m=16 did not fit in cap_g")
    assert not check_gv("dense", dense_text, dense_pat, dense=True), (
        "(h) the dense text did not outnumber cap_g")
    launches_h = {k: f.launches for k, f in h_kernels.items()}
    for k, v in launches_h.items():
        assert v > 0, f"kernel {k} was not launched by the exp/ path"
    launches.update({k: launches_h[k] for k in ("screen_cand_nibsums", "gather_verify")})
    print(f"exp/ path launches (h): {launches_h} ({time.perf_counter() - t_h:.1f} s for (h))")

    # -- (i) streaming over config 2's corpus on disk, counters zeroed ------
    t_i = time.perf_counter()
    n_chunks = -(-len(big) // DEFAULT_CHUNK_BYTES)
    assert (n_chunks, len(big) - (n_chunks - 1) * DEFAULT_CHUNK_BYTES) == (15, 60_475_904), (
        "(i) config 2 is not 15 chunks with a ragged last one")
    stream_dir = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        launches_i = stream_phase(stream_dir, big, c2_pats, c2_cfg, c2_want, dense_text,
                                  dense_pat, cfg, kernels, zero_counts, card,
                                  DEFAULT_CHUNK_BYTES)
        print(f"(i) {time.perf_counter() - t_i:.1f} s for (i)")
        # -- (j) the sharded paths on a one-rank NCCL group, counters zeroed -
        t_j = time.perf_counter()
        launches_j = dist_phase(stream_dir, eng, b"quick brown fox ", big, c2_pats, c2_cfg,
                                c2_want, dense_text, dense_pat, kernels, zero_counts, card)
        print(f"(j) {time.perf_counter() - t_j:.1f} s for (j) {card}")
        # -- (k) the command line, counters zeroed ----------------------------
        t_k = time.perf_counter()
        launches_k = cli_phase(stream_dir, eng, b"quick brown fox ", c2_pats, c2_cap,
                               c2_want, dense_text, dense_pat, kernels, zero_counts,
                               card, DEFAULT_CHUNK_BYTES)
        print(f"(k) {time.perf_counter() - t_k:.1f} s for (k) {card}")
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)

    # -- (e) timings ---------------------------------------------------------
    text, pat = corpora["english"]
    n = len(text)
    padded = on_card("english", text)
    p256, p509 = long_pats["english"][256], long_pats["english"][509]
    bm = BoyerMooreMatcher(pat, cfg, device=dev)
    Nk, cut = swar.kernel_region(padded.numel(), bm.m, cfg.pallas_chunk_bytes)
    limit = min(n - bm.m, cut - 1)
    region = padded.view(torch.int32)[: Nk // 4]
    P, M, probes = bm.dev_tables["swar_p"], bm.swar_m, bm.dev_tables["probes"]
    u8 = lambda b: np.frombuffer(b, np.uint8)  # noqa: E731
    bt16 = torch.from_numpy(shift_and.b_table(u8(pat))).to(dev)
    bt256 = torch.from_numpy(shift_and.b_table(u8(p256))).to(dev)
    p64 = long_pats["english"][64]
    bt64 = torch.from_numpy(shift_and.b_table(u8(p64))).to(dev)
    base = int(tables.RK_BASE)
    t16 = torch.tensor([int(tables.rk_hash(u8(pat)))], device=dev)
    t509 = torch.tensor([int(tables.rk_hash(u8(p509)))], device=dev)
    t8 = torch.tensor([int(tables.rk_hash(u8(p))) for p in config2_patterns(text)],
                      device=dev)
    lay8 = swar.static_probes_from_table(swar.probe_table(u8(pat)))
    # Bound of each case: the bytes it must move (the region read once, its
    # outputs written once: block sums Nk/128 bytes, a nibble plane Nk) and
    # the integer operations this input needs: a masked compare (AND,
    # compare) per probe word and alignment per word, plus the verify of
    # the candidate words (one alignment's nw compares) for K7/K8; one
    # masked compare per alignment per word for the exact verify (a chain
    # stops at its first mismatch); for the automaton of K state words two
    # per word per byte (a funnel shift, an AND) plus one for the hit, and
    # K table lookups per byte in shared memory, whatever step or lookup K9
    # takes, since every variant computes K4's / K10a's function; two
    # multiply-adds plus one compare per target per byte for the hash, the
    # same for K6's pattern mask: a start's pattern bits are needed only
    # where it hits.
    words, bsb = Nk / 4, Nk / 128
    n_probe = sum(len(ks) for ks in probes)
    nw = P.shape[1]
    screen_ops = words * 2 * n_probe + cand_words["english"] * 2 * nw

    def kmp(n_bytes, K):  # the automaton's (bytes, operations, lookups)
        return n_bytes, Nk * (2 * K + 1), Nk * K

    shapes = {  # (kernel, what): (bytes, operations[, lookups])
        ("screen_cand_bsums", "m=16"): (Nk + bsb, words * 2 * n_probe),
        ("naive_nib", "m=16"): (2 * Nk + bsb, words * 8),
        ("naive_bsums", "m=16"): (Nk + bsb, words * 8),
        ("kmp_bsums", "m=16"): kmp(Nk + bsb, 1),
        ("kmp_bsums", "m=64 K=2"): kmp(Nk + bsb, 2),
        ("kmp_bsums", "m=256 K=8"): kmp(Nk + bsb, 8),
        ("rk_candidate_bsums", "m=16"): (Nk + bsb, Nk * 3),
        ("rk_candidate_bsums", "m=509"): (Nk + bsb, Nk * 3),
        ("rk_candidate_bsums", "k=8 m=16"): (Nk + bsb, Nk * 10),
        ("rk_candidate_pmask", "k=8 m=16"): (Nk + bsb, Nk * 10),
        ("screened_nib", "m=16 K7"): (2 * Nk + bsb, screen_ops),
        ("screened_nib", "m=16 K8"): (2 * Nk + bsb, screen_ops),
        ("screened_bsums", "m=16 K7"): (Nk + bsb, screen_ops),
        ("kmp_nib", "m=16"): kmp(2 * Nk + bsb, 1),
        ("kmp_nib", "m=64 K=2"): kmp(2 * Nk + bsb, 2),
        ("kmp_nib", "m=256 K=8"): kmp(2 * Nk + bsb, 8),
        ("rk_candidate_nib", "m=16"): (2 * Nk + bsb, Nk * 3),
        ("rk_candidate_nib", "m=509"): (2 * Nk + bsb, Nk * 3),
        ("rk_candidate_nib", "k=8 m=16"): (2 * Nk + bsb, Nk * 10),
        ("kmp_bsums_composed", "m=16"): kmp(Nk + bsb, 1),
        ("kmp_bsums_composed", "m=256 K=8"): kmp(Nk + bsb, 8),
        ("kmp_bsums_compare_b", "m=16"): kmp(Nk + bsb, 1),
        ("kmp_bsums_compare_b", "m=16 composed"): kmp(Nk + bsb, 1),
        ("kmp_nib_composed", "m=16"): kmp(2 * Nk + bsb, 1),
        ("kmp_nib_composed", "m=256 K=8"): kmp(2 * Nk + bsb, 8),
        ("kmp_nib_compare_b", "m=16"): kmp(2 * Nk + bsb, 1),
        ("kmp_nib_compare_b", "m=16 composed"): kmp(2 * Nk + bsb, 1),
        ("rk_candidate_bmask", "k=8 m=16"): (Nk + bsb, Nk * 10),
    }
    cases = {  # (kernel, what): (kernel call, plain call, plain iterations)
        ("screen_cand_bsums", "m=16"): (
            lambda: swar.screen_cand_bsums(region, limit, P, M, probes),
            lambda: swar.screen_cand_bsums_plain(region, limit, P, M, probes), 5),
        ("naive_nib", "m=16"): (
            lambda: swar.naive_nib(region, limit, P, M),
            lambda: swar.naive_nib_plain(region, limit, P, M), 5),
        ("naive_bsums", "m=16"): (
            lambda: swar.naive_bsums(region, limit, P, M),
            lambda: swar.naive_bsums_plain(region, limit, P, M), 5),
        ("kmp_bsums", "m=16"): (
            lambda: shift_and.kmp_bsums(region, n - 16, bt16, 16),
            lambda: shift_and.kmp_bsums_plain(region, n - 16, bt16, 16), 5),
        ("kmp_bsums", "m=64 K=2"): (
            lambda: shift_and.kmp_bsums(region, n - 64, bt64, 64),
            lambda: shift_and.kmp_bsums_plain(region, n - 64, bt64, 64), 2),
        ("kmp_bsums", "m=256 K=8"): (
            lambda: shift_and.kmp_bsums(region, n - 256, bt256, 256),
            lambda: shift_and.kmp_bsums_plain(region, n - 256, bt256, 256), 2),
        ("rk_candidate_bsums", "m=16"): (
            lambda: rk_roll.rk_candidate_bsums(region, n - 16, t16, 16, base),
            lambda: rk_roll.rk_candidate_bsums_plain(region, n - 16, t16, 16, base), 3),
        ("rk_candidate_bsums", "m=509"): (
            lambda: rk_roll.rk_candidate_bsums(region, n - 509, t509, 509, base),
            lambda: rk_roll.rk_candidate_bsums_plain(region, n - 509, t509, 509, base), 1),
        ("rk_candidate_bsums", "k=8 m=16"): (
            lambda: rk_roll.rk_candidate_bsums(region, n - 16, t8, 16, base),
            lambda: rk_roll.rk_candidate_bsums_plain(region, n - 16, t8, 16, base), 3),
        ("rk_candidate_pmask", "k=8 m=16"): (
            lambda: rk_roll.rk_candidate_pmask(region, n - 16, t8, 16, base),
            lambda: rk_roll.rk_candidate_pmask_plain(region, n - 16, t8, 16, base), 3),
        ("screened_nib", "m=16 K7"): (
            lambda: swar.screened_nib(region, limit, P, M, probes),
            lambda: swar.screened_nib_plain(region, limit, P, M, probes), 3),
        ("screened_nib", "m=16 K8"): (
            lambda: swar.screened_nib(region, limit, P, M, lay8),
            lambda: swar.screened_nib_plain(region, limit, P, M, lay8), 3),
        ("screened_bsums", "m=16 K7"): (
            lambda: swar.screened_bsums(region, limit, P, M, probes),
            lambda: swar.screened_bsums_plain(region, limit, P, M, probes), 3),
        ("kmp_nib", "m=16"): (
            lambda: shift_and.kmp_nib(region, n - 16, bt16, 16),
            lambda: shift_and.kmp_nib_plain(region, n - 16, bt16, 16), 3),
        ("kmp_nib", "m=64 K=2"): (
            lambda: shift_and.kmp_nib(region, n - 64, bt64, 64),
            lambda: shift_and.kmp_nib_plain(region, n - 64, bt64, 64), 1),
        ("kmp_nib", "m=256 K=8"): (
            lambda: shift_and.kmp_nib(region, n - 256, bt256, 256),
            lambda: shift_and.kmp_nib_plain(region, n - 256, bt256, 256), 1),
        ("rk_candidate_nib", "m=16"): (
            lambda: rk_roll.rk_candidate_nib(region, n - 16, t16, 16, base),
            lambda: rk_roll.rk_candidate_nib_plain(region, n - 16, t16, 16, base), 2),
        ("rk_candidate_nib", "m=509"): (
            lambda: rk_roll.rk_candidate_nib(region, n - 509, t509, 509, base),
            lambda: rk_roll.rk_candidate_nib_plain(region, n - 509, t509, 509, base), 1),
        ("rk_candidate_nib", "k=8 m=16"): (
            lambda: rk_roll.rk_candidate_nib(region, n - 16, t8, 16, base),
            lambda: rk_roll.rk_candidate_nib_plain(region, n - 16, t8, 16, base), 2),
        ("rk_candidate_bmask", "k=8 m=16"): (
            lambda: rk_roll.rk_candidate_bmask(region, n - 16, t8, 16, base),
            lambda: rk_roll.rk_candidate_bmask_plain(region, n - 16, t8, 16, base), 2),
    }
    # K9 beside K4 / K10a: each variant of each wrapper at m=16 and (the
    # composed step) K=8 m=256; every variant's plain version is K4's /
    # K10a's.
    for fn, plain in ((shift_and.kmp_bsums, shift_and.kmp_bsums_plain),
                      (shift_and.kmp_nib, shift_and.kmp_nib_plain)):
        for what, bt_, m_, path, key in (("m=16", bt16, 16, "composed", None),
                                         ("m=256 K=8", bt256, 256, "composed", None),
                                         ("m=16", bt16, 16, "perbyte", pat),
                                         ("m=16 composed", bt16, 16, "composed", pat)):
            k9 = f"{fn.__name__}_{'compare_b' if key else 'composed'}"
            cases[(k9, what)] = (
                functools.partial(on_step, path, fn, region, n - m_, bt_, m_, pat_key=key),
                functools.partial(plain, region, n - m_, bt_, m_), 1)
    # K11a as K1 (its bound too); K11d at each cap_g on the groups of K11a's
    # candidates, cap_g 4096 first (the JSON line's case).  K11d's bound:
    # the listed groups read once with their halo, the ids read, the nibble
    # rows and row counts written; K2's eight operations per verified word.
    shapes[("screen_cand_nibsums", "m=16")] = (Nk + bsb + 4, words * 2 * n_probe)
    cases[("screen_cand_nibsums", "m=16")] = (
        lambda: swar.screen_cand_nibsums(region, limit, P, M, probes),
        lambda: swar.screen_cand_nibsums_plain(region, limit, P, M, probes), 5)
    assert Nk == padded.numel(), "(e) the padded text is not whole tiles"
    bs_a = swar.screen_cand_nibsums(region, limit, P, M, probes)[0]
    gv_ids = {c: proto_kernels.group_ids(bs_a, c) for c in (4096, 1024, 2048)}
    for c, g8 in gv_ids.items():
        listed = int((g8 < padded.numel() // group_bytes).sum())
        shapes[("gather_verify", f"m=16 cap_g={c}")] = (
            listed * (group_bytes + 4 * (nw - 1)) + c * (4 + group_bytes + 32) + 4,
            listed * swar.GROUP_WORDS * 8)
        cases[("gather_verify", f"m=16 cap_g={c}")] = (
            functools.partial(swar.gather_verify, region, g8, limit, P, M),
            functools.partial(swar.gather_verify_plain, region, g8, limit, P, M), 5)
    # K1-K8, K10a-c and K11a take 0.1-0.6 ms, where back-to-back event times
    # can measure the host's launch path: each also reports its own device
    # time per call from the profiler, and that is its time in the JSON
    # line.  The profiler's kernel name shows which kernel ran: K4, K10a
    # and K9 the warp kernel, K11d K2's verify on gathered tiles (its
    # memset apart, below).
    own_kernel = {"screen_cand_bsums": ("screen_cand_kernel", swar.screen_cand_bsums),
                  "screen_cand_nibsums": ("screen_cand_kernel", swar.screen_cand_nibsums),
                  "naive_nib": ("naive_kernel", swar.naive_nib),
                  "naive_bsums": ("naive_kernel", swar.naive_bsums),
                  "screened_nib": ("naive_kernel", swar.screened_nib),
                  "screened_bsums": ("naive_kernel", swar.screened_bsums),
                  "rk_candidate_bsums": ("rk_warp_kernel", rk_roll.rk_candidate_bsums),
                  "rk_candidate_nib": ("rk_warp_kernel", rk_roll.rk_candidate_nib),
                  "rk_candidate_pmask": ("rk_warp_kernel", rk_roll.rk_candidate_pmask),
                  "rk_candidate_bmask": ("rk_warp_kernel", rk_roll.rk_candidate_bmask),
                  "kmp_bsums": ("kmp_warp_kernel", shift_and.kmp_bsums),
                  "kmp_nib": ("kmp_warp_kernel", shift_and.kmp_nib),
                  "gather_verify": ("naive_groups_kernel", swar.gather_verify),
                  **{k9: ("kmp_warp_kernel", shift_and.kmp_nib if k9.startswith("kmp_nib")
                          else shift_and.kmp_bsums) for k9 in K9_NAMES}}
    ms, plain_ms, bounds, shape = {}, {}, {}, {}
    for (k, what), (kern, plain, plain_iters) in cases.items():
        kt = cuda_ms(kern, 20)
        pt = cuda_ms(plain, plain_iters, warmup=1)
        b_ms, b_by = bound(*shapes[(k, what)])
        own = ""
        t = kt
        if k in own_kernel:
            t, seen = kernel_device_ms(kern, 20, *own_kernel[k])
            own = (f", device {t:.4f} ms per call (profiler, {seen} of 20 launches "
                   f"recorded, {b_ms / t:.3f} of the bound)")
        if k not in ms:  # the JSON line reports each kernel's first case
            ms[k], plain_ms[k], bounds[k], shape[k] = t, pt, (b_ms, b_by), what
        # Text bytes per second; K11d reads only its groups: bytes it moves.
        rate = (f"{Nk / t / 1e6:.1f} GB/s kernel" if k != "gather_verify" else
                f"{shapes[(k, what)][0] / t / 1e6:.1f} GB/s moved")
        print(f"(e) {k} 256 MiB english {what}: kernel {kt:.4f} ms (events){own}, plain "
              f"{pt:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_ms / kt:.3f} of it), "
              f"{rate} {card}")
        torch.cuda.empty_cache()

    # Device-resident run per algorithm, sparse and nib in alternating passes.
    for algo in ALGOS:
        mts = {e: matchers[algo](pat, cfg.replace(emission=e), device=dev)
               for e in ("sparse", "nib")}
        passes = {e: [] for e in mts}
        for _ in range(3):
            for e, mt in mts.items():
                passes[e] += host_ms(lambda: mt.run(padded, n), iters=10, passes=1)
        for e, mt in mts.items():
            dev_ms, per_run, _ = device_profile(lambda: mt.run(padded, n), runs=5)
            med = statistics.median(passes[e])
            print(f"(e) match device-resident 256 MiB english m=16 algo={algo} "
                  f"emission={e}: passes {[round(x, 4) for x in passes[e]]} ms, median "
                  f"{med:.4f} ms = {n / med / 1e6:.1f} GB/s; profiler: device "
                  f"{dev_ms:.4f} ms/run, {per_run:.0f} device events/run, idle share "
                  f"{1 - dev_ms / med:.3f} of the median pass {card}")
        host = host_ms(lambda: match(text, pat, algo=algo), iters=2, passes=2)
        print(f"(e) match from host bytes 256 MiB english m=16 algo={algo}: passes "
              f"{[round(x, 4) for x in host]} ms, best {min(host):.4f} ms = "
              f"{n / min(host) / 1e6:.1f} GB/s {card}")

    km = KMPMatcher(p509, cfg, device=dev)
    _, kcut = shift_and.kernel_region(padded.numel(), 509, cfg.pallas_chunk_bytes)
    tail = padded[kcut:]
    tail_ms = host_ms(lambda: kmp_ops.kmp_start_mask(tail, km.dev_tables["dfa"],
                                                      cfg.kmp_chunk), iters=3)
    run_ms = host_ms(lambda: km.run(padded, n), iters=3)
    # kmp_start_mask scans nothing when the tail is shorter than m.
    steps = 0 if 509 > tail.numel() else min(cfg.kmp_chunk, tail.numel()) + 508
    print(f"(e) KMP m=509 dense-DFA tail ({tail.numel()} B, {steps} steps): "
          f"passes {[round(x, 4) for x in tail_ms]} ms; "
          f"match device-resident m=509: passes {[round(x, 4) for x in run_ms]} ms "
          f"{card}")

    # Config 2 at 1 GB: K6, K10c and K10b alone (events and device time,
    # against their bound and their plain versions), the per-pattern
    # extraction branch K6 leads to, and RabinKarpMultiMatcher.run on the
    # device-resident text.
    big_dev = to_device(pad_to_multiple(big_np, 2 * MIB), dev)
    nb = len(big)
    mm = RabinKarpMultiMatcher(c2_pats, c2_cfg, device=dev)
    big_region = big_dev.view(torch.int32)  # the padded text is whole tiles
    tgt = mm.dev_tables["hashes"]

    def time_1gb(fn, plain, what: str, plane: bool = False) -> None:
        """Event and device time of ``fn`` on config 2's 1 GB region, held
        against ``plain``; the bound counts 2 + k operations per byte and a
        nibble plane's write where there is one."""
        call = functools.partial(fn, big_region, nb - 16, tgt, 16, base)
        ref = functools.partial(plain, big_region, nb - 16, tgt, 16, base)
        kt = cuda_ms(call, 10)
        dt, seen = kernel_device_ms(call, 10, "rk_warp_kernel", fn)
        pt = cuda_ms(ref, 1, warmup=1)
        hold(fn.__name__, f"1 GB english k=8 m=16 ({what})", call(), ref(), quiet=True)
        b_ms, b_by = bound((2 if plane else 1) * big_dev.numel() + big_dev.numel() / 128,
                           big_dev.numel() * 10)
        print(f"(e) {fn.__name__} 1 GB english k=8 m=16 ({what}): max_abs_err 0 against "
              f"its plain version; kernel {kt:.4f} ms (events), device {dt:.4f} ms per "
              f"call (profiler, {seen} of 10 launches recorded, {b_ms / dt:.3f} of the "
              f"bound), plain {pt:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
              f"{big_region.numel() * 4 / dt / 1e6:.1f} GB/s kernel {card}")
        torch.cuda.empty_cache()

    time_1gb(rk_roll.rk_candidate_pmask, rk_roll.rk_candidate_pmask_plain, "config 2")
    time_1gb(rk_roll.rk_candidate_bmask, rk_roll.rk_candidate_bmask_plain,
             "config 2 under groups")
    bm = rk_roll.rk_candidate_bmask(big_region, nb - 16, tgt, 16, base)
    print(f"(e) config 2 under groups: {popcount16(bm)} occupied groups in "
          f"{int((bm != 0).sum())} candidate blocks (gather width "
          f"{reconstruct.MULTI_BLOCK_TIER})")
    del bm
    torch.cuda.empty_cache()
    time_1gb(rk_roll.rk_candidate_nib, rk_roll.rk_candidate_nib_plain,
             "config 2 under nib", plane=True)
    mms = {"sparse": mm,
           "sparse groups": RabinKarpMultiMatcher(c2_pats, groups_cfg, device=dev),
           "nib": RabinKarpMultiMatcher(c2_pats, c2_nib, device=dev)}
    passes = {e: [] for e in mms}
    for _ in range(3):
        for e, mt in mms.items():
            passes[e] += host_ms(lambda: mt.run(big_dev, nb), iters=3, passes=1)
    for e, mt in mms.items():
        dev_ms, per_run, _ = device_profile(lambda: mt.run(big_dev, nb), runs=3)
        med = statistics.median(passes[e])
        print(f"(e) config 2 RabinKarpMultiMatcher.run device-resident 1 GB k=8 m=16 "
              f"emission={e}: passes {[round(x, 4) for x in passes[e]]} ms, median "
              f"{med:.4f} ms = {nb / med / 1e6:.1f} GB/s; profiler: device "
              f"{dev_ms:.4f} ms/run, {per_run:.0f} device events/run, idle share "
              f"{1 - dev_ms / med:.3f} of the median pass {card}")
    host = host_ms(lambda: match(big, c2_pats, algo="rabin_karp", config=c2_cfg),
                   iters=1, passes=2)
    print(f"(e) config 2 match from host bytes 1 GB: passes "
          f"{[round(x, 4) for x in host]} ms, best {min(host):.4f} ms = "
          f"{nb / min(host) / 1e6:.1f} GB/s {card}")
    del big_dev, big_region
    torch.cuda.empty_cache()

    # bm_variant='cursor' on the device-resident 256 MiB text.
    bmc = BoyerMooreMatcher(pat, cursor_cfg, device=dev)
    run_ms = host_ms(lambda: bmc.run(padded, n), iters=1, passes=3)
    dev_ms, per_run, _ = device_profile(lambda: bmc.run(padded, n), runs=1)
    print(f"(e) match device-resident 256 MiB english m=16 bm_variant=cursor: passes "
          f"{[round(x, 4) for x in run_ms]} ms; profiler: device {dev_ms:.4f} ms/run, "
          f"{per_run:.0f} device events/run, idle share "
          f"{1 - dev_ms / statistics.median(run_ms):.3f} of the median pass {card}")

    # A K11d call is a memset and a kernel of a few microseconds each, so
    # its event time above is the host's launch path: the device's share,
    # the kernel and the memset apart.
    for c, g8 in gv_ids.items():
        dev_ms, per_run, split = device_profile(functools.partial(
            swar.gather_verify, region, g8, limit, P, M), runs=20)
        parts = ", ".join(f"{name[:40]} {x:.4f} ms" for name, x in split.items())
        print(f"(e) gather_verify m=16 cap_g={c}: device {dev_ms:.4f} ms per call in "
              f"{per_run:.0f} device events ({parts}) {card}")

    # The exp/ path: the reference's "kernel+gids" (group ids and K11d) and
    # "full recon" (and the decode) per cap_g, then gv_offsets (screen
    # included) against BoyerMooreMatcher.run in alternating passes.
    bmr = BoyerMooreMatcher(pat, cfg, device=dev)
    for c in cap_gs:
        tk = cuda_ms(functools.partial(proto_kernels.verify_groups, region, bs_a, n, P,
                                       bmr.m, c, None), 20)
        tf = cuda_ms(functools.partial(proto_kernels.verify_groups, region, bs_a, n, P,
                                       bmr.m, c, cfg.capacity), 20)
        print(f"(e) exp/ path 256 MiB english m=16 cap_g={c}: kernel+gids {tk:.4f} ms, "
              f"full recon {tf:.4f} ms {card}")
    paths = {"BoyerMooreMatcher.run": lambda: bmr.run(padded, n),
             "gv_offsets cap_g=4096": functools.partial(
                 proto_kernels.gv_offsets, region, n, P, bmr.m, probes, 4096, cfg.capacity)}
    assert paths["gv_offsets cap_g=4096"]()[1].tolist() == find_all(text, pat)[: cfg.capacity]
    passes = {k: [] for k in paths}
    for _ in range(3):
        for k, f in paths.items():
            passes[k] += host_ms(f, iters=10, passes=1)
    for k, f in paths.items():
        dev_ms, per_run, _ = device_profile(f, runs=5)
        med = statistics.median(passes[k])
        print(f"(e) {k} device-resident 256 MiB english m=16: passes "
              f"{[round(x, 4) for x in passes[k]]} ms, median {med:.4f} ms; profiler: "
              f"device {dev_ms:.4f} ms/run, {per_run:.0f} device events/run, idle share "
              f"{1 - dev_ms / med:.3f} of the median pass {card}")

    assert "jax" not in sys.modules, "the port imported jax"
    sources = {"screen_cand_bsums": ("swar.cu", "kernels/swar.py:477"),
               "naive_nib": ("swar.cu", "kernels/swar.py:386"),
               "naive_bsums": ("swar.cu", "kernels/swar.py:438"),
               "kmp_bsums": ("shift_and.cu", "kernels/shift_and.py:245"),
               "rk_candidate_bsums": ("rk_roll.cu", "kernels/rk_roll.py:93"),
               "rk_candidate_pmask": ("rk_roll.cu",
                                      "kernels/rk_roll.py:93 emit='pmask' + "
                                      f"{REF}/kernels/shift_and.py:196"),
               "screened_nib": ("swar.cu", "kernels/swar.py:393 + "
                                f"{REF}/kernels/swar.py:515 (emit_nib=True)"),
               "screened_bsums": ("swar.cu", "kernels/swar.py:393 + "
                                  f"{REF}/kernels/swar.py:515 (emit_nib=False)"),
               "kmp_nib": ("shift_and.cu", "kernels/shift_and.py:245 emit='nib' + "
                           f"{REF}/kernels/shift_and.py:557"),
               "rk_candidate_nib": ("rk_roll.cu", "kernels/rk_roll.py:93 emit='nib' + "
                                    f"{REF}/kernels/shift_and.py:557"),
               "kmp_bsums_composed": ("shift_and.cu", "kernels/shift_and.py:335 "
                                      "group_composed (emit='bsums')"),
               "kmp_bsums_compare_b": ("shift_and.cu", "kernels/shift_and.py:316 "
                                       "lookup_compare (emit='bsums', pat_key)"),
               "kmp_nib_composed": ("shift_and.cu", "kernels/shift_and.py:335 "
                                    "group_composed (emit='nib')"),
               "kmp_nib_compare_b": ("shift_and.cu", "kernels/shift_and.py:316 "
                                     "lookup_compare (emit='nib', pat_key)"),
               "rk_candidate_bmask": ("rk_roll.cu", "kernels/rk_roll.py:93 emit='bmask' + "
                                      f"{REF}/kernels/shift_and.py:224"),
               "screen_cand_nibsums": ("swar.cu", "exp/screen_kernel_opt.py:91 _v1_kernel "
                                       "(pallas_call :180) + exp/proto_kernels.py:60 "
                                       "_proto_screen_kernel (pallas_call :122)"),
               "gather_verify": ("swar.cu", "exp/proto_kernels.py:157 _gv_kernel "
                                 "(pallas_call :227)")}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the "
          f"kernels line {card}")
    print(nvidia_smi())
    # No single PyTorch call computes any of these functions: library_ms null.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"{PKG}/csrc/{src}",
         "replaces": ref if ref.startswith("exp/") else f"{REF}/{ref}",
         "launches": launches[k],
         "max_abs_err": errs[k], "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None,
         "shape": f"256 MiB english {shape[k]}", "stream_launches": launches_i.get(k, 0),
         "dist_launches": launches_j.get(k, 0), "cli_launches": launches_k.get(k, 0)}
        for k, (src, ref) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
