"""PyTorch port on the card: the CUDA kernels (K1-K11d) against their
plain versions and against the ported kernel with the same answer, and
``match()`` of every algorithm, of every ``emission``, Boyer-Moore screen,
probe mode and variant, of KMP's composed step, and of pattern lists under
every ``multi_gather``, the ``exp/`` gather-verify path,
``match_stream`` (pinned reader, side copy stream, resolver), and the
sharded paths on a one-rank NCCL group, against the oracle.  Every test here is marked
``cuda`` and skips without a GPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine without jax, where ``tests/conftest.py`` (which imports jax) must
be left out:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import _torch_threads  # noqa: F401

import json
import socket

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    StreamingMatcher,
    match,
    match_distributed,
    match_multihost,
    match_multihost_streaming,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    shift_and,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    tables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
    pad_to_multiple,
)

pytestmark = pytest.mark.cuda

TILE = 128 * 4096  # default-config tile
PATTERNS = [
    b"quick brown fox ",
    b"e",
    b"e ",
    b"\x00ab\x00",
    b"fox jumps over lazy dog and cat with so",
    bytes(range(1, 256)) + bytes(range(1, 255)),  # m = 509
]


@pytest.fixture
def cuda_device():
    """The card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _region(n: int, pat: bytes, device):
    data = bytearray(gen_english(n, seed=len(pat)))
    m = len(pat)
    for off in (0, 4093, TILE - m // 2, n // 2 + 1, n - m):
        data[off : off + m] = pat
    padded = pad_to_multiple(np.frombuffer(bytes(data), np.uint8), TILE)
    P, M = swar.pattern_words(np.frombuffer(pat, np.uint8))
    Nk, cut = swar.kernel_region(len(padded), m, 4096)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    limit = min(n - m, cut - 1)
    return (words.to(device), limit, torch.from_numpy(P).to(device),
            torch.from_numpy(M).to(device))


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 1234, 4 * TILE], ids=["n<Nk", "n=Nk"])
def test_kernels_bit_exact_against_plain(pat, n, cuda_device):
    """Both kernels equal their plain versions (tolerance 0), and each
    launch adds one to its counter."""
    words, limit, P, M = _region(n, pat, cuda_device)
    probes = swar.static_probes_from_table(
        swar.probe_table(np.frombuffer(pat, np.uint8), use_gs=True))
    k1, k2 = swar.screen_cand_bsums.launches, swar.naive_nib.launches
    bs = swar.screen_cand_bsums(words, limit, P, M, probes)
    nib, bs2 = swar.naive_nib(words, limit, P, M)
    torch.cuda.synchronize()
    assert (swar.screen_cand_bsums.launches, swar.naive_nib.launches) == (k1 + 1, k2 + 1)
    assert torch.equal(bs, swar.screen_cand_bsums_plain(words, limit, P, M, probes))
    nib_p, bs2_p = swar.naive_nib_plain(words, limit, P, M)
    assert torch.equal(nib, nib_p) and torch.equal(bs2, bs2_p)
    assert int(bs2.sum()) == len(find_all(
        words.cpu().numpy().tobytes()[: limit + len(pat)], pat))


RAGGED_PATTERNS = [b"e", b"quick brown fox ", b"ab\x00\x00",
                   bytes(range(1, 256)) + bytes(range(1, 255))]  # m = 509
TILE_BLOCKS = 32  # 512-byte blocks per tile of the tiled K1-K3


def _ragged_region(blocks: int, pat: bytes) -> np.ndarray:
    """tests/test_torch_swar.py's ragged region: int32 words of ``blocks``
    512-byte blocks of seeded English, whole copies of ``pat`` planted and
    its first two bytes as the region's last two."""
    n = 512 * blocks
    data = bytearray(gen_english(n, seed=blocks + len(pat)))
    m = len(pat)
    end = 0
    for off in (0, n // 2 - 3, n - 512 - m // 2, n - 300, n - m - 7):
        if off >= end and off + m <= n:
            data[off : off + m] = pat
            end = off + m
    data[n - len(pat[:2]) :] = pat[:2]
    return np.frombuffer(bytes(data), np.int32)


def _placed(words: np.ndarray, where: str, device) -> torch.Tensor:
    """``words`` on the card as a fresh tensor.  'end': the last words of an
    allocation of whole 2 MiB pages, at least 10 MiB so that the caching
    allocator maps it on its own, with nothing after it.  'lead': one word
    into a buffer of -1 words, which also follow it: a start off its
    16-byte line, and garbage wherever a read past the end would land.
    'lead16': the same, 16 bytes in."""
    n = words.size
    if where == "end":
        torch.cuda.empty_cache()
        total = max(-(-4 * n // (2 << 20)) * (2 << 20), 10 << 20) // 4
        buf = torch.full((total,), -1, dtype=torch.int32, device=device)
        region = buf[total - n:]
    else:
        lead = 4 if where == "lead16" else 1
        buf = torch.full((n + lead + 128,), -1, dtype=torch.int32, device=device)
        region = buf[lead : lead + n]
    region.copy_(torch.from_numpy(words.copy()))
    return region


@pytest.mark.parametrize("where", ["end", "lead"])
@pytest.mark.parametrize("pat", RAGGED_PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("length", [1, 31, 32, 33, 97, "span+1"])
def test_tiled_scans_bit_exact_on_ragged_regions(length, pat, where, cuda_device):
    """K1 (under the 'static', 'table_gs' and 'table_gs1' probe layouts),
    K2, K3, K7/K8 (``screened_nib`` and ``screened_bsums`` under the
    'table_gs' and the 'table_dyn' probes, also against K2 and K3) and K11a
    (``screen_cand_nibsums``, the same two probe sets) equal their plain
    versions bit for bit (tolerance 0) on
    regions of 1, 31, 32, 33 and 97 blocks and of one tile more than a
    whole number of grid spans ('span+1': SMs x c tiles + 1 for every
    c = 1..8 CTAs per SM, so one of them is the kernel's span plus one
    whatever its occupancy), with n_lim mid-way into the last block and at
    its last byte; each launch counts once."""
    u = np.frombuffer(pat, np.uint8)
    P, M = (torch.from_numpy(a).to(cuda_device) for a in swar.pattern_words(u))
    layouts = {
        "static": swar.probe_indices(swar.mask_words(len(pat))),
        "table_gs": swar.static_probes_from_table(swar.probe_table(u, use_gs=True)),
        "table_gs1": swar.static_probes_from_table(
            swar.probe_table(u, use_gs=True, single=True)),
    }
    screened = {"table_gs": layouts["table_gs"],
                "table_dyn": swar.static_probes_from_table(swar.probe_table(u))}
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lengths = ([TILE_BLOCKS * (sms * c + 1) for c in range(1, 9)]
               if length == "span+1" else [length])
    for blocks in lengths:
        words = _placed(_ragged_region(blocks, pat), where, cuda_device)
        n = 4 * words.numel()
        for n_lim in (n - 512 + 137, n - 1):
            what = f"{blocks} blocks, n_lim {n_lim}"
            for name, probes in layouts.items():
                k1 = swar.screen_cand_bsums.launches
                bs1 = swar.screen_cand_bsums(words, n_lim, P, M, probes)
                torch.cuda.synchronize()
                assert swar.screen_cand_bsums.launches == k1 + 1
                assert torch.equal(
                    bs1, swar.screen_cand_bsums_plain(words, n_lim, P, M, probes)), (
                    f"K1 {name}, {what}")
            k2, k3 = swar.naive_nib.launches, swar.naive_bsums.launches
            nib, bs2 = swar.naive_nib(words, n_lim, P, M)
            bs3 = swar.naive_bsums(words, n_lim, P, M)
            torch.cuda.synchronize()
            assert (swar.naive_nib.launches, swar.naive_bsums.launches) == (k2 + 1, k3 + 1)
            nib_p, bs_p = swar.naive_nib_plain(words, n_lim, P, M)
            assert torch.equal(nib, nib_p) and torch.equal(bs2, bs_p), f"K2, {what}"
            assert torch.equal(bs3, bs_p), f"K3, {what}"
            assert int(bs_p.sum()) > 0
            for name, probes in screened.items():
                counts = (swar.screened_nib.launches, swar.screened_bsums.launches,
                          swar.screen_cand_nibsums.launches)
                got7 = swar.screened_nib(words, n_lim, P, M, probes)
                got8 = swar.screened_bsums(words, n_lim, P, M, probes)
                got11 = swar.screen_cand_nibsums(words, n_lim, P, M, probes)
                torch.cuda.synchronize()
                assert (swar.screened_nib.launches, swar.screened_bsums.launches,
                        swar.screen_cand_nibsums.launches) == tuple(c + 1 for c in counts)
                plain7 = swar.screened_nib_plain(words, n_lim, P, M, probes)
                assert torch.equal(got7[0], plain7[0]) and torch.equal(got7[1], plain7[1]), (
                    f"K7/K8 nib {name}, {what}")
                assert torch.equal(got7[0], nib) and torch.equal(got7[1], bs2), (
                    f"K7/K8 nib {name} vs K2, {what}")
                assert torch.equal(got8, swar.screened_bsums_plain(
                    words, n_lim, P, M, probes)), f"K7/K8 bsums {name}, {what}"
                assert torch.equal(got8, bs3), f"K7/K8 bsums {name} vs K3, {what}"
                plain11 = swar.screen_cand_nibsums_plain(words, n_lim, P, M, probes)
                assert torch.equal(got11[0], plain11[0]) and torch.equal(
                    got11[1], plain11[1]), f"K11a {name}, {what}"
        del words


RK_SCANS = [(2, 1, None), (2, 8, None), (16, 1, None), (16, 8, None),
            (509, 1, None), (509, 8, None), (16, 8, 0x9E3779B1), (16, 31, None),
            (509, 31, None), (16, 40, None)]


@pytest.mark.parametrize("where", ["end", "lead16"])
@pytest.mark.parametrize("m,k,base", RK_SCANS,
                         ids=[f"m{m}-k{k}{'-odd' if b else ''}" for m, k, b in RK_SCANS])
@pytest.mark.parametrize("length", [1, 31, 32, 33, 97, "span+1"])
def test_rk_scans_bit_exact_on_ragged_regions(length, m, k, base, where, cuda_device):
    """K5, K10b, K6 and K10c (one warp-per-block kernel over a persistent
    grid, four epilogues) equal their plain versions bit for bit (tolerance
    0) on regions of 1, 31, 32, 33 and 97 blocks and of one tile more than
    a whole number of grid spans (as in
    test_tiled_scans_bit_exact_on_ragged_regions), with n_lim mid-way into
    the last block and at its last byte, k targets (the first planted in
    the region; k = 31 fills K6's mask, k = 40 is past it and runs the
    other three) and the default or another odd base; each launch counts
    once.  'lead16' places the region 16 bytes into a buffer of -1 words
    (the RK wrappers refuse a start off its 16-byte line)."""
    pat = (bytes(range(1, 256)) + bytes(range(1, 255)))[:m] if m == 509 else (
        b"quick brown fox "[:m])
    base = int(tables.RK_BASE) if base is None else base
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lengths = ([TILE_BLOCKS * (sms * c + 1) for c in range(1, 9)]
               if length == "span+1" else [length])
    c = tables.rk_constants(m, base)
    for blocks in lengths:
        host = _ragged_region(blocks, pat)
        text = host.tobytes()
        pats = [pat] + [text[(97 * i) % (len(text) - m) :][:m] for i in range(1, k)]
        tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in pats],
                           device=cuda_device)
        words = _placed(host, where, cuda_device)
        n = 4 * words.numel()
        for n_lim in (n - 512 + 137, n - 1):
            what = f"{blocks} blocks, n_lim {n_lim}"
            counts = (rk_roll.rk_candidate_bsums.launches, rk_roll.rk_candidate_nib.launches,
                      rk_roll.rk_candidate_pmask.launches, rk_roll.rk_candidate_bmask.launches)
            with_pm = k <= rk_roll.MAX_PMASK_PATTERNS
            bs = rk_roll.rk_candidate_bsums(words, n_lim, tgt, m, base)
            nib, bs10 = rk_roll.rk_candidate_nib(words, n_lim, tgt, m, base)
            if with_pm:
                pm = rk_roll.rk_candidate_pmask(words, n_lim, tgt, m, base)
            bm = rk_roll.rk_candidate_bmask(words, n_lim, tgt, m, base)
            torch.cuda.synchronize()
            assert (rk_roll.rk_candidate_bsums.launches, rk_roll.rk_candidate_nib.launches,
                    rk_roll.rk_candidate_pmask.launches,
                    rk_roll.rk_candidate_bmask.launches) == (
                        counts[0] + 1, counts[1] + 1, counts[2] + with_pm, counts[3] + 1)
            nib_p, bs_p = rk_roll.rk_candidate_nib_plain(words, n_lim, tgt, m, base)
            assert torch.equal(bs, bs_p), f"K5, {what}"
            assert torch.equal(nib, nib_p) and torch.equal(bs10, bs_p), f"K10b, {what}"
            if with_pm:
                assert torch.equal(pm, rk_roll.rk_candidate_pmask_plain(
                    words, n_lim, tgt, m, base)), f"K6, {what}"
            assert torch.equal(bm, rk_roll.rk_candidate_bmask_plain(
                words, n_lim, tgt, m, base)), f"K10c, {what}"
            assert int(bs_p.sum()) > 0
        del words


def test_refused_launch_raises(cuda_device):
    """A launch the C entry refuses (word count not a multiple of 128)
    surfaces as an exception."""
    w = torch.zeros(256, dtype=torch.int32, device=cuda_device)
    P = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        swar._launch("tpm_naive_nib", w.device, w.data_ptr(), 100, 0,
                     P.data_ptr(), P.data_ptr(), 2, w.data_ptr(), w.data_ptr())


def test_match_end_to_end(cuda_device):
    """match() on the card: exact against the oracle, through K1 and the
    decode, the dense pattern too, with no K2 rescan; drain complete."""
    text = bytes(gen_english(4 << 20, seed=21))
    cfg = MatchConfig(capacity=4096)
    for pat in (b"quick brown fox ", b"e "):  # sparse, dense
        k1, k2 = swar.screen_cand_bsums.launches, swar.naive_nib.launches
        d = swar.decode_blocks.launches
        r = match(text, pat, config=cfg)
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want[:4096]
        assert swar.screen_cand_bsums.launches == k1 + 1
        assert swar.decode_blocks.launches == d + 1 and swar.naive_nib.launches == k2
        r = match(text, pat, config=cfg, drain=True)
        assert r.offsets_list() == want


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 1234, 4 * TILE], ids=["n<Nk", "n=Nk"])
def test_scan_kernels_bit_exact_against_plain(pat, n, cuda_device):
    """K3, K4 (the whole pattern up to 256 bytes, and the pattern[:32]
    screen above 32) and K5 equal their plain versions (tolerance 0); each
    launch adds one to its counter.  At C = 4096 the three kernels share
    the SWAR region."""
    words, limit, P, M = _region(n, pat, cuda_device)
    m = len(pat)
    Nk = 4 * words.numel()
    assert shift_and.kernel_region(-(-n // TILE) * TILE, m, 4096)[0] == Nk
    k3 = swar.naive_bsums.launches
    exact = swar.naive_bsums(words, limit, P, M)
    torch.cuda.synchronize()
    assert swar.naive_bsums.launches == k3 + 1
    assert torch.equal(exact, swar.naive_bsums_plain(words, limit, P, M))
    heads = [pat[:32]] if m > 32 else []
    if shift_and.shift_and_supported(m):
        heads.append(pat)
    for head in heads:
        mk = len(head)
        bt = torch.from_numpy(shift_and.b_table(_u8(head))).to(cuda_device)
        k4 = shift_and.kmp_bsums.launches
        bs = shift_and.kmp_bsums(words, min(n, Nk) - mk, bt, mk)
        torch.cuda.synchronize()
        assert shift_and.kmp_bsums.launches == k4 + 1
        assert torch.equal(bs, shift_and.kmp_bsums_plain(words, min(n, Nk) - mk, bt, mk))
        if mk == m:
            assert torch.equal(bs, exact)
    if rk_roll.rk_roll_supported(m):
        base = int(tables.RK_BASE)
        tgt = torch.tensor([int(tables.rk_hash(_u8(pat)))], device=cuda_device)
        k5 = rk_roll.rk_candidate_bsums.launches
        bs = rk_roll.rk_candidate_bsums(words, limit, tgt, m, base)
        torch.cuda.synchronize()
        assert rk_roll.rk_candidate_bsums.launches == k5 + 1
        assert torch.equal(bs, rk_roll.rk_candidate_bsums_plain(words, limit, tgt, m, base))
        assert bool((bs >= exact).all())


@pytest.mark.parametrize("m", [33, 64, 100, 200, 256])
def test_kmp_multiword_automaton_bit_exact(m, cuda_device):
    """K4 at K = 2..8 state words (kmp_long='ripple'), exact match counts."""
    pat = bytes(gen_english(m, seed=900 + m))
    words, limit, P, M = _region(3 * TILE + 77, pat, cuda_device)
    bt = torch.from_numpy(shift_and.b_table(_u8(pat))).to(cuda_device)
    bs = shift_and.kmp_bsums(words, limit, bt, m)
    assert torch.equal(bs, shift_and.kmp_bsums_plain(words, limit, bt, m))
    assert torch.equal(bs, swar.naive_bsums_plain(words, limit, P, M))
    assert int(bs.sum()) >= 4


def test_rk_kernel_other_base_and_targets(cuda_device):
    """K5 with a non-default odd base and several targets (the
    multi-pattern form), against its plain version."""
    pat = b"quick brown fox "
    words, limit, _, _ = _region(2 * TILE, pat, cuda_device)
    base = 0x9E3779B1
    c = tables.rk_constants(16, base)
    tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in
                        (pat, b"lazy dog and cat", b"\xff" * 16)],
                       device=cuda_device)
    bs = rk_roll.rk_candidate_bsums(words, limit, tgt, 16, base)
    assert torch.equal(bs, rk_roll.rk_candidate_bsums_plain(words, limit, tgt, 16, base))
    assert int(bs.sum()) > 5


@pytest.mark.parametrize("algo", ["naive", "kmp", "rabin_karp"])
def test_match_end_to_end_per_algorithm(algo, cuda_device):
    """match() of each algorithm on 4 MiB: exact against the oracle, one
    launch of its scan kernel per call; drain complete."""
    text = bytes(gen_english(4 << 20, seed=22))
    cfg = MatchConfig(capacity=4096)
    kernel = {"naive": swar.naive_bsums, "kmp": shift_and.kmp_bsums,
              "rabin_karp": rk_roll.rk_candidate_bsums}[algo]
    for pat in (b"quick brown fox ", b"e ", text[1000:1064], text[5000:5509]):
        before = kernel.launches
        r = match(text, pat, algo=algo, config=cfg)
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want[:4096]
        assert kernel.launches == before + 1
    r = match(text, b"the ", algo=algo, config=cfg, drain=True)
    assert r.offsets_list() == find_all(text, b"the ")


@pytest.mark.parametrize("algo", ["boyer_moore", "naive", "kmp", "rabin_karp"])
def test_count_only_match(algo, cuda_device):
    """capacity=0 on the card: the oracle's count, no offsets, overflow
    exactly when there is a match, under both emissions, for a pattern and
    a list; drain=True with capacity=0 raises."""
    text = bytes(gen_english(4 << 20, seed=23))
    for e in ("sparse", "nib"):
        cfg = MatchConfig(capacity=0, emission=e)
        for pat in (b"quick brown fox ", b"e ", b"zq\x00zq", text[5000:5509]):
            r = match(text, pat, algo=algo, config=cfg)
            n = len(find_all(text, pat))
            assert (r.count, r.offsets_list(), r.overflow) == (n, [], n > 0), (e, pat)
        pats = [b"quick brown fox ", b"lazy dog and cat", b"the "]
        for pat, r in zip(pats, match(text, pats, algo=algo, config=cfg)):
            n = len(find_all(text, pat))
            assert (r.count, r.offsets_list(), r.overflow) == (n, [], n > 0), (e, pat)
    with pytest.raises(ValueError):
        match(text, b"the ", algo=algo, config=MatchConfig(capacity=0), drain=True)


@pytest.mark.parametrize("m", [2, 16, 509])
@pytest.mark.parametrize("k", [1, 8, 31])
def test_pmask_kernel_bit_exact(k, m, cuda_device):
    """K6 equals its plain version (tolerance 0) for k patterns drawn from
    the text (bit k-1 included), one launch per call; its mask is nonzero
    exactly where K5's count over the same targets is."""
    n = 3 * TILE + 1234
    text = gen_english(n, seed=1000 + k + m)
    pats = [text[7919 * i + 11 : 7919 * i + 11 + m] for i in range(k)]
    words, limit, _, _ = _region(n, pats[-1], cuda_device)
    base = int(tables.RK_BASE)
    c = tables.rk_constants(m, base)
    tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in pats],
                       device=cuda_device)
    before = rk_roll.rk_candidate_pmask.launches
    pm = rk_roll.rk_candidate_pmask(words, limit, tgt, m, base)
    torch.cuda.synchronize()
    assert rk_roll.rk_candidate_pmask.launches == before + 1
    assert torch.equal(pm, rk_roll.rk_candidate_pmask_plain(words, limit, tgt, m, base))
    bs = rk_roll.rk_candidate_bsums(words, limit, tgt, m, base)
    assert torch.equal(pm != 0, bs != 0)
    assert int(((pm >> (k - 1)) & 1).sum()) >= 4  # the planted last pattern
    with pytest.raises(ValueError, match="at most 31"):
        rk_roll.rk_candidate_pmask(words, limit, tgt.repeat(32)[:32], m, base)


@pytest.mark.parametrize("mode", ["pselect", "blocks", "k64"])
def test_multi_match_end_to_end(mode, cuda_device):
    """match() of a pattern list on the card, 4 MiB: every result exact
    against the oracle; pselect launches K6 once, blocks and k = 64 launch
    K5 once; duplicates and absent patterns included."""
    text = bytes(gen_english(4 << 20, seed=23))
    k = 64 if mode == "k64" else 8
    offs = [(i * 524287) % (len(text) - 16) for i in range(k - 2)]
    pats = [text[o : o + 16] for o in offs]
    pats += [pats[0], b"\x00 never here! \xfe\xff"]  # a duplicate, an absent one
    cfg = MatchConfig(capacity=4096, multi_gather="blocks" if mode == "blocks"
                      else "pselect")
    k5, k6 = rk_roll.rk_candidate_bsums.launches, rk_roll.rk_candidate_pmask.launches
    rs = match(text, pats, algo="rabin_karp", config=cfg)
    for p, r in zip(pats, rs):
        want = find_all(text, p)
        assert r.algo == "rabin_karp_multi"
        assert r.count == len(want) and r.offsets_list() == want[:4096], p
    pselect = mode == "pselect"
    assert rk_roll.rk_candidate_pmask.launches == k6 + pselect
    assert rk_roll.rk_candidate_bsums.launches == k5 + (not pselect)
    mm = RabinKarpMultiMatcher(pats, cfg, device=cuda_device)
    assert [c for c, _, _ in mm.run(mm.patterns_dev.new_zeros(TILE * 4), 0)] == [0] * k


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 1234, 4 * TILE], ids=["n<Nk", "n=Nk"])
def test_nib_kernels_bit_exact(pat, n, cuda_device):
    """K7/K8 (``screened_nib``/``screened_bsums``, with the 'table_gs' and
    the 'table_dyn' probes), K10a (``kmp_nib``, m <= 256) and K10b
    (``rk_candidate_nib``, 2 <= m <= 509) equal their plain versions
    (tolerance 0), one launch per call; K7/K8 equal K2/K3, K10a equals K2
    and K4, K10b's counts equal K5's and its plane holds every true start."""
    words, limit, P, M = _region(n, pat, cuda_device)
    m = len(pat)
    u = _u8(pat)
    nib2, bs2 = swar.naive_nib(words, limit, P, M)
    bs3 = swar.naive_bsums(words, limit, P, M)
    for table in (swar.probe_table(u, use_gs=True), swar.probe_table(u)):
        probes = swar.static_probes_from_table(table)
        k7, k7b = swar.screened_nib.launches, swar.screened_bsums.launches
        nib, bs = swar.screened_nib(words, limit, P, M, probes)
        bsb = swar.screened_bsums(words, limit, P, M, probes)
        torch.cuda.synchronize()
        assert (swar.screened_nib.launches, swar.screened_bsums.launches) == (k7 + 1, k7b + 1)
        nib_p, bs_p = swar.screened_nib_plain(words, limit, P, M, probes)
        assert torch.equal(nib, nib_p) and torch.equal(bs, bs_p)
        assert torch.equal(bsb, swar.screened_bsums_plain(words, limit, P, M, probes))
        assert torch.equal(nib, nib2) and torch.equal(bs, bs2) and torch.equal(bsb, bs3)
    if shift_and.shift_and_supported(m):
        bt = torch.from_numpy(shift_and.b_table(u)).to(cuda_device)
        k10 = shift_and.kmp_nib.launches
        nib, bs = shift_and.kmp_nib(words, limit, bt, m)
        torch.cuda.synchronize()
        assert shift_and.kmp_nib.launches == k10 + 1
        nib_p, bs_p = shift_and.kmp_nib_plain(words, limit, bt, m)
        assert torch.equal(nib, nib_p) and torch.equal(bs, bs_p)
        assert torch.equal(nib, nib2) and torch.equal(bs, bs2)
        assert torch.equal(bs, shift_and.kmp_bsums(words, limit, bt, m))
    if rk_roll.rk_roll_supported(m):
        base = int(tables.RK_BASE)
        tgt = torch.tensor([int(tables.rk_hash(u))], device=cuda_device)
        k10 = rk_roll.rk_candidate_nib.launches
        nib, bs = rk_roll.rk_candidate_nib(words, limit, tgt, m, base)
        torch.cuda.synchronize()
        assert rk_roll.rk_candidate_nib.launches == k10 + 1
        nib_p, bs_p = rk_roll.rk_candidate_nib_plain(words, limit, tgt, m, base)
        assert torch.equal(nib, nib_p) and torch.equal(bs, bs_p)
        assert torch.equal(bs, rk_roll.rk_candidate_bsums(words, limit, tgt, m, base))
        assert torch.equal(nib & nib2, nib2)


@pytest.mark.parametrize("k", [1, 8, 40])
def test_rk_nib_kernel_k_targets(k, cuda_device):
    """K10b with k targets equals its plain version and K5 over the same
    targets; each pattern's true starts are among its candidates."""
    n = 3 * TILE + 1234
    text = gen_english(n, seed=2000 + k)
    pats = [text[7919 * i + 11 : 7919 * i + 27] for i in range(k)]
    words, limit, _, _ = _region(n, pats[-1], cuda_device)
    base = int(tables.RK_BASE)
    c = tables.rk_constants(16, base)
    tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in pats],
                       device=cuda_device)
    nib, bs = rk_roll.rk_candidate_nib(words, limit, tgt, 16, base)
    nib_p, bs_p = rk_roll.rk_candidate_nib_plain(words, limit, tgt, 16, base)
    assert torch.equal(nib, nib_p) and torch.equal(bs, bs_p)
    assert torch.equal(bs, rk_roll.rk_candidate_bsums(words, limit, tgt, 16, base))
    for p in pats:
        P, M = (torch.from_numpy(a).to(cuda_device) for a in swar.pattern_words(_u8(p)))
        exact = swar.naive_nib(words, limit, P, M)[0]
        assert torch.equal(nib & exact, exact)


NIB_ROUTES = {  # route: (config overrides, algo, the kernel it launches)
    "naive nib": ({"emission": "nib"}, "naive", swar.naive_nib),
    "kmp nib": ({"emission": "nib"}, "kmp", shift_and.kmp_nib),
    "rk nib": ({"emission": "nib"}, "rabin_karp", rk_roll.rk_candidate_nib),
    "bm nib": ({"emission": "nib"}, "boyer_moore", swar.screened_nib),
    "bm table_dyn nib": ({"emission": "nib", "bm_probes": "table_dyn"},
                         "boyer_moore", swar.screened_nib),
    "bm fused": ({"bm_screen": "fused"}, "boyer_moore", swar.screened_bsums),
    "bm table_dyn": ({"bm_probes": "table_dyn"}, "boyer_moore",
                     swar.screened_bsums),
    "bm table_gs1": ({"bm_probes": "table_gs1"}, "boyer_moore",
                     swar.screen_cand_bsums),
}


@pytest.mark.parametrize("route", list(NIB_ROUTES))
def test_opt_in_routes_end_to_end(route, cuda_device):
    """match() of each opt-in route on 4 MiB: exact against the oracle, one
    launch of its kernel per call (KMP's m = 300 and Rabin-Karp's m = 600
    take their plain masks); drain complete."""
    kw, algo, kernel = NIB_ROUTES[route]
    text = bytes(gen_english(4 << 20, seed=24))
    cfg = MatchConfig(capacity=4096, verify_capacity=4096, **kw)
    for pat in (b"quick brown fox ", b"e ", text[1000:1064], text[5000:5256],
                text[6000:6300], text[7000:7509], text[8000:8600]):
        m = len(pat)
        runs = not ((algo == "kmp" and m > 256) or m > 509)
        before = kernel.launches
        r = match(text, pat, algo=algo, config=cfg)
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want[:4096], m
        assert kernel.launches == before + runs, m
    r = match(text, b"the ", algo=algo, config=cfg, drain=True)
    assert r.offsets_list() == find_all(text, b"the ")


@pytest.mark.parametrize("k", [8, 40])
def test_multi_nib_end_to_end(k, cuda_device):
    """A pattern list under emission='nib' on 4 MiB: every result exact
    against the oracle, K10b launched once for the group."""
    text = bytes(gen_english(4 << 20, seed=25))
    pats = [text[(i * 524287) % (len(text) - 16):][:16] for i in range(k - 1)]
    pats.append(b"\x00 never here! \xfe\xff")
    cfg = MatchConfig(capacity=4096, emission="nib")
    before = rk_roll.rk_candidate_nib.launches
    rs = match(text, pats, algo="rabin_karp", config=cfg)
    for p, r in zip(pats, rs):
        want = find_all(text, p)
        assert r.count == len(want) and r.offsets_list() == want[:4096], p
    assert rk_roll.rk_candidate_nib.launches == before + 1


@pytest.mark.parametrize("m", [5, 16, 32, 33, 64, 256])
def test_k9_variants_bit_exact(m, cuda_device, monkeypatch):
    """K9 at 4 MiB: the composed-4 step (K = 1..8) and the compare-B lookup
    (K = 1, alone and with the composed step) equal the plain versions and
    K4 / K10a (tolerance 0) under both emissions; one launch per call,
    counted per variant (compare-B has no effect at K > 1)."""
    pat = bytes(gen_english(m, seed=1100 + m))
    if m == 32:  # bit 31 of B set: the compare mask wraps as int32
        pat = pat[:31] + pat[:1]
    words, limit, P, M = _region(8 * TILE, pat, cuda_device)
    bt = torch.from_numpy(shift_and.b_table(_u8(pat))).to(cuda_device)
    monkeypatch.setattr(shift_and, "STEP_PATH", "perbyte")
    bs4 = shift_and.kmp_bsums(words, limit, bt, m)
    nib10, bs10 = shift_and.kmp_nib(words, limit, bt, m)
    assert torch.equal(bs4, shift_and.kmp_bsums_plain(words, limit, bt, m))
    nib_p, bs_p = shift_and.kmp_nib_plain(words, limit, bt, m)
    assert torch.equal(nib10, nib_p) and torch.equal(bs10, bs_p)
    for path, key in (("composed", None), ("perbyte", pat), ("composed", pat)):
        monkeypatch.setattr(shift_and, "STEP_PATH", path)
        counts = [(f.launches, dict(f.k9_launches))
                  for f in (shift_and.kmp_bsums, shift_and.kmp_nib)]
        bs = shift_and.kmp_bsums(words, limit, bt, m, pat_key=key)
        nib, bsn = shift_and.kmp_nib(words, limit, bt, m, pat_key=key)
        torch.cuda.synchronize()
        step = {"composed": int(path == "composed"),
                "compare_b": int(key is not None and m <= 32)}
        for f, (n0, k9) in zip((shift_and.kmp_bsums, shift_and.kmp_nib), counts):
            assert f.launches == n0 + 1
            assert f.k9_launches == {v: k9[v] + step[v] for v in k9}
        assert torch.equal(bs, bs4) and torch.equal(nib, nib10)
        assert torch.equal(bsn, bs10)
    assert int(bs4.sum()) >= 4


KMP_RAGGED_M = [1, 2, 5, 16, 17, 31, 32, 33, 64, 255, 256]


def _kmp_ragged_patterns(m: int) -> list[bytes]:
    """An English slice of m bytes and, for m >= 2, the same ending in NUL
    bytes (two, one at m = 2)."""
    base = b"e" if m == 1 else bytes(gen_english(m, seed=1300 + m))
    if m == 1:
        return [base]
    z = 1 if m == 2 else 2
    return [base, base[: m - z] + b"\x00" * z]


def _kmp_ragged_region(blocks: int, pat: bytes) -> np.ndarray:
    """int32 words of ``blocks`` 512-byte blocks of seeded English with
    ``pat`` planted across every block boundary (so across every span
    boundary of the warp kernel whatever its grid) at varying offsets, at
    every other one with one byte changed (a near miss), and the region
    ending in ``pat`` without its trailing NUL bytes: with n_lim at the
    last byte, a start there matches against the zeros past the region."""
    n = 512 * blocks
    data = bytearray(gen_english(n, seed=1400 + blocks + len(pat)))
    m = len(pat)
    end = 0
    for b in range(1, blocks):
        off = 512 * b - m // 2 - b % 3
        if off >= end and off + m <= n:
            data[off : off + m] = pat
            if b % 2:
                data[off + (7 * b) % m] ^= 3
            end = off + m
    head = pat.rstrip(b"\x00")
    data[n - len(head) :] = head
    return np.frombuffer(bytes(data), np.int32)


@pytest.mark.parametrize("where", ["end", "lead16"])
@pytest.mark.parametrize("m", KMP_RAGGED_M)
@pytest.mark.parametrize("length", [1, 31, 32, 33, 97, "span+1"])
def test_kmp_scans_bit_exact_on_ragged_regions(length, m, where, cuda_device, monkeypatch):
    """K4 and K10a (the warp kernel: each warp carries the automaton over a
    contiguous span of blocks) equal their plain versions bit for bit
    (tolerance 0) at K = 1, 2 and 8 state words on regions of 1, 31, 32, 33
    and 97 blocks and of one tile more than a whole number of grid spans
    (as in test_tiled_scans_bit_exact_on_ragged_regions), with the pattern
    across every block boundary, n_lim mid-way into the last block and at
    its last byte, and a pattern ending in NUL bytes that matches at the
    region's end; K9 (composed step, m >= 5, and compare-B, m <= 32) equals
    them; each launch counts once."""
    monkeypatch.setattr(shift_and, "STEP_PATH", "perbyte")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lengths = ([TILE_BLOCKS * (sms * c + 1) for c in range(1, 9)]
               if length == "span+1" else [length])
    for pat in _kmp_ragged_patterns(m):
        bt = torch.from_numpy(shift_and.b_table(_u8(pat))).to(cuda_device)
        k9 = ([("composed", None)] if m >= shift_and.COMPOSED_MIN_M else []) + (
            [("perbyte", pat)] if m <= 32 else [])
        for blocks in lengths:
            words = _placed(_kmp_ragged_region(blocks, pat), where, cuda_device)
            n = 4 * words.numel()
            for n_lim in (n - 512 + 137, n - 1):
                what = f"{pat!r} {blocks} blocks, n_lim {n_lim}"
                counts = (shift_and.kmp_bsums.launches, shift_and.kmp_nib.launches)
                bs = shift_and.kmp_bsums(words, n_lim, bt, m)
                nib, bs10 = shift_and.kmp_nib(words, n_lim, bt, m)
                torch.cuda.synchronize()
                assert (shift_and.kmp_bsums.launches, shift_and.kmp_nib.launches) == (
                    counts[0] + 1, counts[1] + 1)
                nib_p, bs_p = shift_and.kmp_nib_plain(words, n_lim, bt, m)
                assert torch.equal(bs, bs_p), f"K4, {what}"
                assert torch.equal(nib, nib_p) and torch.equal(bs10, bs_p), f"K10a, {what}"
                assert int(bs_p.sum()) >= (blocks > 1)
                for path, key in k9:
                    monkeypatch.setattr(shift_and, "STEP_PATH", path)
                    got = shift_and.kmp_nib(words, n_lim, bt, m, pat_key=key)
                    assert torch.equal(got[0], nib_p) and torch.equal(got[1], bs_p), (
                        f"K9 {path} {'compare-B' if key else ''}, {what}")
                    monkeypatch.setattr(shift_and, "STEP_PATH", "perbyte")
            if pat.endswith(b"\x00"):  # the start at the region's end counts
                s = n - len(pat.rstrip(b"\x00"))
                assert int(nib_p[s // 4]) >> (s % 4) & 1, what
            del words


def test_kmp_launches_name_their_kernel(cuda_device, monkeypatch):
    """On the card K4, K10a and every K9 variant (composed step, compare-B
    per byte and composed) run ``kmp_warp_kernel``: the kernel names
    torch.profiler records for one call each."""
    pat = b"quick brown fox "
    words, limit, _, _ = _region(TILE, pat, cuda_device)
    bt = torch.from_numpy(shift_and.b_table(_u8(pat))).to(cuda_device)
    for path, key in (("perbyte", None), ("composed", None), ("perbyte", pat),
                      ("composed", pat)):
        monkeypatch.setattr(shift_and, "STEP_PATH", path)
        for fn in (shift_and.kmp_bsums, shift_and.kmp_nib):
            names = _kernel_names(lambda: fn(words, limit, bt, len(pat), pat_key=key), "kmp_")
            assert names and all("kmp_warp_kernel" in x for x in names), (
                fn.__name__, path, names)


def test_gather_verify_names_its_kernel(cuda_device):
    """On the card K11d runs ``naive_groups_kernel``, K2's verify on
    gathered tiles (with a memset of the total beside it)."""
    pat = b"quick brown fox "
    words, limit, P, M = _region(2 * TILE, pat, cuda_device)
    g8 = torch.tensor([0, 3, 3, 200, words.numel() // swar.GROUP_WORDS], dtype=torch.int32,
                      device=cuda_device)
    names = _kernel_names(lambda: swar.gather_verify(words, g8, limit, P, M), "_kernel")
    assert names == {x for x in names if "naive_groups_kernel" in x} and len(names) == 1, names


@pytest.mark.parametrize("m", [2, 16, 40, 509])
def test_gather_verify_bit_exact_on_id_lists(m, cuda_device):
    """K11d on the tiled verify equals its plain version (tolerance 0) and
    K2's rows on id lists with the region's last group (its halo past the
    text), repeated and unordered ids, negative, out-of-range and fill ids,
    more ids than the grid has CTAs, at a clamp inside a listed group and
    at the last valid start; m = 509's halo reaches into the next group."""
    pat = bytes(gen_english(8192, seed=6)[200 : 200 + m])
    n = 8 * TILE
    data = bytearray(gen_english(n, seed=m + 40))
    for off in [4096 * (g + 1) - m // 2 - 1 for g in range(0, 1024, 37)] + [n - m]:
        data[off : off + m] = pat
    words = torch.from_numpy(np.frombuffer(bytes(data), np.int32).copy()).to(cuda_device)
    P, M = (torch.from_numpy(a).to(cuda_device) for a in swar.pattern_words(_u8(pat)))
    nb8 = words.numel() // swar.GROUP_WORDS
    k2 = swar.naive_nib(words, n - m, P, M)[0].view(-1, 8, 128)
    lists = [[nb8 - 1, 0, 37, 37, 1000, nb8, -1, nb8 + 5, 36, nb8 - 1],
             list(range(nb8 - 1, -1, -1)) * 5 + [nb8] * 7]
    for n_lim in (n - m, 4096 * 37 + 1500):
        if n_lim != n - m:
            k2 = swar.naive_nib(words, n_lim, P, M)[0].view(-1, 8, 128)
        for ids in lists:
            g8 = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
            got = swar.gather_verify(words, g8, n_lim, P, M)
            want = swar.gather_verify_plain(words, g8, n_lim, P, M)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (m, n_lim, len(ids))
            listed = (g8 >= 0) & (g8 < nb8)
            rows = torch.zeros_like(got[0])
            rows[listed] = k2[g8[listed].long()]
            assert torch.equal(got[0], rows), (m, n_lim, len(ids))
            assert int(got[2]) > 0


def _kernel_names(fn, part: str) -> set:
    """Names of the kernels holding ``part`` that torch.profiler records
    for one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name}


def test_kmp_composed_match_end_to_end(cuda_device, monkeypatch):
    """match(algo='kmp') with ``shift_and.STEP_PATH = "composed"`` on
    4 MiB, sparse (the m > 32 screen too) and 'nib': exact against the
    oracle, every launch on the composed step."""
    monkeypatch.setattr(shift_and, "STEP_PATH", "composed")
    text = bytes(gen_english(4 << 20, seed=26))
    for emission, kernel in (("sparse", shift_and.kmp_bsums),
                             ("nib", shift_and.kmp_nib)):
        cfg = MatchConfig(capacity=4096, emission=emission)
        for pat in (b"quick brown fox ", b"e the", text[1000:1064], text[5000:5256]):
            before = kernel.k9_launches["composed"]
            r = match(text, pat, algo="kmp", config=cfg)
            want = find_all(text, pat)
            assert r.count == len(want) and r.offsets_list() == want[:4096]
            assert kernel.k9_launches["composed"] == before + 1


@pytest.mark.parametrize("k,m", [(1, 16), (8, 16), (40, 12), (2, 509)])
def test_bmask_kernel_bit_exact(k, m, cuda_device):
    """K10c equals its plain version (tolerance 0), one launch per call; it
    is nonzero exactly where K5's count over the same targets is, and holds
    every true start's group."""
    n = 3 * TILE + 1234
    text = gen_english(n, seed=3000 + k + m)
    pats = [text[7919 * i + 11 : 7919 * i + 11 + m] for i in range(k)]
    words, limit, _, _ = _region(n, pats[-1], cuda_device)
    base = int(tables.RK_BASE)
    c = tables.rk_constants(m, base)
    tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in pats],
                       device=cuda_device)
    before = rk_roll.rk_candidate_bmask.launches
    bm = rk_roll.rk_candidate_bmask(words, limit, tgt, m, base)
    torch.cuda.synchronize()
    assert rk_roll.rk_candidate_bmask.launches == before + 1
    assert torch.equal(bm, rk_roll.rk_candidate_bmask_plain(words, limit, tgt, m, base))
    bs = rk_roll.rk_candidate_bsums(words, limit, tgt, m, base)
    assert torch.equal(bm != 0, bs != 0) and int(bm.max()) < 1 << 16
    region = words.cpu().numpy().tobytes()
    for p in pats:
        for s0 in find_all(region[: limit + m], p):
            assert int(bm[s0 // 512]) >> (s0 % 512 // 32) & 1


@pytest.mark.parametrize("mode", ["k8", "k40", "m40"])
def test_groups_match_end_to_end(mode, cuda_device):
    """match() of a pattern list with multi_gather='groups' on 4 MiB: every
    result exact against the oracle; K10c launched once (m <= 33), or K5
    for m = 40, which takes 'blocks'."""
    text = bytes(gen_english(4 << 20, seed=27))
    k, m = {"k8": (8, 16), "k40": (40, 12), "m40": (8, 40)}[mode]
    pats = [text[(i * 524287) % (len(text) - m):][:m] for i in range(k - 1)]
    pats.append(b"\x00" * (m - 1) + b"\xfe")  # absent
    cfg = MatchConfig(capacity=4096, multi_gather="groups")
    k5, k10 = rk_roll.rk_candidate_bsums.launches, rk_roll.rk_candidate_bmask.launches
    rs = match(text, pats, algo="rabin_karp", config=cfg)
    for p, r in zip(pats, rs):
        want = find_all(text, p)
        assert r.algo == "rabin_karp_multi"
        assert r.count == len(want) and r.offsets_list() == want[:4096], p
    groups = m <= 33
    assert rk_roll.rk_candidate_bmask.launches == k10 + groups
    assert rk_roll.rk_candidate_bsums.launches == k5 + (not groups)


def test_cursor_match_end_to_end(cuda_device):
    """match() with bm_variant='cursor' on 4 MiB: exact against the oracle,
    no screen kernel launched, the offsets a CUDA tensor before the host
    copy; drain complete."""
    text = bytes(gen_english(4 << 20, seed=28))
    cfg = MatchConfig(capacity=4096, bm_variant="cursor")
    for pat in (b"quick brown fox ", b"e ", text[5000:5509]):
        before = (swar.screen_cand_bsums.launches, swar.screened_bsums.launches,
                  swar.screened_nib.launches)
        r = match(text, pat, config=cfg)
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want[:4096]
        assert (swar.screen_cand_bsums.launches, swar.screened_bsums.launches,
                swar.screened_nib.launches) == before
    bm = BoyerMooreMatcher(b"quick brown fox ", cfg, device=cuda_device)
    padded = torch.from_numpy(pad_to_multiple(_u8(text), TILE).copy()).to(cuda_device)
    count, offsets, _ = bm.run(padded, len(text))
    assert offsets.is_cuda and count == len(find_all(text, b"quick brown fox "))
    r = match(text, b"the ", config=cfg, drain=True)
    assert r.offsets_list() == find_all(text, b"the ")


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 1234, 4 * TILE], ids=["n<Nk", "n=Nk"])
def test_exp_kernels_bit_exact_against_plain(pat, n, cuda_device):
    """K11a and K11d equal their plain versions (tolerance 0); per block
    K2's count <= K11a's <= 4 K1's; K11d's rows are K2's nibble plane on
    the listed groups and zero for fill ids; each launch counts once."""
    words, limit, P, M = _region(n, pat, cuda_device)
    probes = swar.static_probes_from_table(
        swar.probe_table(np.frombuffer(pat, np.uint8), use_gs=True))
    before = (swar.screen_cand_nibsums.launches, swar.gather_verify.launches)
    bs, total = swar.screen_cand_nibsums(words, limit, P, M, probes)
    nb8 = words.numel() // swar.GROUP_WORDS
    g8 = torch.tensor([0, 1, 127, 128, 301, nb8 - 1, nb8, nb8], dtype=torch.int32,
                      device=cuda_device)
    nib, bsr, cnt = swar.gather_verify(words, g8, limit, P, M)
    torch.cuda.synchronize()
    assert (swar.screen_cand_nibsums.launches,
            swar.gather_verify.launches) == (before[0] + 1, before[1] + 1)
    bs_p, total_p = swar.screen_cand_nibsums_plain(words, limit, P, M, probes)
    assert torch.equal(bs, bs_p) and int(total) == int(total_p) == int(bs.sum())
    k1 = swar.screen_cand_bsums(words, limit, P, M, probes)
    k2_nib, k2_bs = swar.naive_nib(words, limit, P, M)
    assert bool((k2_bs <= bs).all()) and bool((bs <= 4 * k1).all())
    want = swar.gather_verify_plain(words, g8, limit, P, M)
    assert all(torch.equal(a, b) for a, b in zip((nib, bsr, cnt), want))
    rows = k2_nib.view(-1, 8, 128)
    for i, g in enumerate(g8.tolist()):
        assert torch.equal(nib[i], rows[g] if g < nb8 else torch.zeros_like(nib[i]))
    assert int(cnt) == int(bsr.sum())


@pytest.mark.parametrize("R", [128, 256, 512])
def test_exp_screen_variants_on_their_regions(R, cuda_device):
    """K11b is K1 on its Nk(R) region; K11a (run_variant 'v1') and K11c
    (proto_screen on both views) equal K11a's plain version."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp import (
        proto_kernels,
        screen_kernel_opt,
    )

    pat = b"quick brown fox "
    m = len(pat)
    words, _, P, M = _region(5 * TILE, pat, cuda_device)
    probes = swar.static_probes_from_table(
        swar.probe_table(np.frombuffer(pat, np.uint8), use_gs=True))
    n = 5 * TILE - 100
    Nk = (5 * TILE // (R * 4096)) * R * 4096
    k1 = swar.screen_cand_bsums.launches
    cnt, bs = screen_kernel_opt.run_variant("v2", words, n, P, m, probes, R)
    assert swar.screen_cand_bsums.launches == k1 + 1
    region = words[: Nk // 4]
    lim = min(n, Nk) - m
    assert torch.equal(bs, swar.screen_cand_bsums_plain(region, lim, P, M, probes))
    assert int(cnt) == int(bs.sum())
    cnt1, bs1 = screen_kernel_opt.run_variant("v1", words, n, P, m, probes, R)
    assert torch.equal(bs1, swar.screen_cand_nibsums_plain(region, lim, P, M, probes)[0])
    if R == 128:
        for view, blocks in ((words.view(-1, 1024), False), (words.view(-1, 128), True)):
            c, b = proto_kernels.proto_screen(view, n, P, m, probes, from_blocks=blocks)
            assert torch.equal(b, bs1) and int(c) == int(cnt1)


@pytest.mark.parametrize("pat", [b"quick brown fox ", b"e ", bytes(range(1, 256)) + b"x"],
                         ids=["m16", "m2", "m256"])
def test_gv_offsets_end_to_end(pat, cuda_device):
    """The exp/ path on 4 MiB: screen, group ids, gather-verify and decode
    equal the oracle when the occupied groups fit in cap_g; past cap_g
    (the dense m=2) they equal the oracle on the listed groups."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp import (
        proto_kernels,
    )

    text = bytearray(gen_english(4 << 20, seed=29))
    for off in (0, TILE - 3, (2 << 20) + 4095, len(text) - len(pat)):
        text[off : off + len(pat)] = pat
    text = bytes(text)
    padded = torch.from_numpy(pad_to_multiple(_u8(text), TILE).copy()).to(cuda_device)
    u = np.frombuffer(pat, np.uint8)
    P = torch.from_numpy(swar.pattern_words(u)[0]).to(cuda_device)
    probes = swar.static_probes_from_table(swar.probe_table(u, use_gs=True))
    cap_g, n = (512 if pat == b"e " else 1024), len(text)
    k11d = swar.gather_verify.launches
    count, offs, overflow = proto_kernels.gv_offsets(
        padded.view(torch.int32), n, P, len(pat), probes, cap_g, 1 << 16)
    assert swar.gather_verify.launches == k11d + 1 and offs.device == padded.device
    want = find_all(text, pat)
    g8 = proto_kernels.group_ids(
        proto_kernels.proto_screen(padded.view(torch.int32).view(-1, 1024), n, P,
                                   len(pat), probes)[1], cap_g)
    listed = {g for g in g8.tolist() if g < padded.numel() // 4096}
    if len(listed) == cap_g:  # the groups were cut at cap_g
        want = [p for p in want if p // 4096 in listed]
    assert pat != b"e " or len(listed) == cap_g
    assert count == len(want) and overflow == (len(want) > 1 << 16)
    assert offs.tolist() == want[: 1 << 16]


# -- streaming ---------------------------------------------------------------

# 512 KiB chunks on 512 KiB tiles for every kernel (pallas_chunk_bytes 4096):
# each chunk's owned bytes are one kernel tile, its halo the plain tail.
STREAM_CHUNK = 128 * 4096
STREAM_CFG = MatchConfig(capacity=4096, pallas_chunk_bytes=4096)
STREAM_PAT = b"quick brown fox "
STREAM_SCAN = {"boyer_moore": swar.screen_cand_bsums, "naive": swar.naive_bsums,
               "kmp": shift_and.kmp_bsums, "rabin_karp": rk_roll.rk_candidate_bsums}


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    """(path, bytes): ~8.5 MiB of English over 18 chunks; STREAM_PAT at
    seam k starting k - 1 bytes before it (every phase from 0 to -15),
    at the start, mid-chunk and ending the file."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    C, m = STREAM_CHUNK, len(STREAM_PAT)
    data = bytearray(gen_english(17 * C + 777, seed=31))
    for k in range(1, 17):
        p = k * C - (k - 1)
        data[p : p + m] = STREAM_PAT
    for p in (0, C // 2 + 3, len(data) - m):
        data[p : p + m] = STREAM_PAT
    path = tmp_path_factory.mktemp("stream") / "corpus.bin"
    path.write_bytes(bytes(data))
    return str(path), bytes(data)


def _stream(path, pattern, algo="boyer_moore", cfg=STREAM_CFG, **kw):
    sm = StreamingMatcher(pattern, algo, cfg, STREAM_CHUNK, device="cuda",
                          manifest_path=kw.pop("manifest_path", None))
    for key, value in kw.pop("attrs", {}).items():
        setattr(sm, key, value)
    return sm, sm.match_file(path, **kw)


@pytest.mark.parametrize("algo", list(STREAM_SCAN))
def test_stream_on_card_exact(algo, cuda_device, stream_file):
    """Every seam phase found once, against the oracle; the algorithm's
    scan kernel launched in every chunk."""
    path, data = stream_file
    before = STREAM_SCAN[algo].launches
    sm, r = _stream(path, STREAM_PAT, algo)
    want = find_all(data, STREAM_PAT)
    assert len(want) >= 19 and r.count == len(want)
    assert r.offsets_list() == want and not r.overflow
    assert sm.last_stats["chunks"] == 18
    assert STREAM_SCAN[algo].launches - before >= 18


def test_stream_on_card_algorithm_list_and_group(cuda_device, stream_file, tmp_path):
    """One pattern under all four algorithms in one pass, and eight 16-byte
    patterns under Rabin-Karp (one K6 pass per chunk), journaled: every
    result and journal equals the oracle."""
    path, data = stream_file
    sm, rs = _stream(path, STREAM_PAT, list(STREAM_SCAN))
    assert [r.offsets_list() for r in rs] == [find_all(data, STREAM_PAT)] * 4
    pats = [STREAM_PAT] + [data[(2 * i + 1) * STREAM_CHUNK - 7 - i:][:16]
                           for i in range(7)]
    k6 = rk_roll.rk_candidate_pmask.launches
    manifest = str(tmp_path / "m.json")
    sm, rs = _stream(path, pats, "rabin_karp", manifest_path=manifest)
    assert len(sm._units) == 1 and sm._units[0].multi
    assert rk_roll.rk_candidate_pmask.launches - k6 >= 18
    for i, (p, r) in enumerate(zip(pats, rs)):
        want = find_all(data, p)
        assert r.count == len(want) and r.offsets_list() == want, p
        assert np.fromfile(f"{manifest}.offsets.{i}", "<i8").tolist() == want


@pytest.mark.parametrize("depth", ["reached", "not_reached"])
def test_stream_on_card_pipeline_depth(depth, cuda_device, stream_file, monkeypatch):
    """The resolver holds chunk 0 until the main thread has packed two more
    chunks, then 0.3 s longer: a queue of one fills (the main thread waits
    to enqueue), a queue of 64 does not.  Both exact, no chunk past its
    capacity."""
    import time as _time

    path, data = stream_file
    packed = []
    pack, save = StreamingMatcher._pack_outputs, StreamingMatcher._save_manifest

    def counted(self, *a):
        packed.append(1)
        return pack(self, *a)

    def held(self, path, rng, next_chunk, *a):
        if next_chunk == 1:
            deadline = _time.monotonic() + 60
            while len(packed) < 3 and _time.monotonic() < deadline:
                _time.sleep(0.001)
            _time.sleep(0.3)
        return save(self, path, rng, next_chunk, *a)

    monkeypatch.setattr(StreamingMatcher, "_pack_outputs", counted)
    monkeypatch.setattr(StreamingMatcher, "_save_manifest", held)
    pats = [STREAM_PAT, b"the ", b"lazy dog"]
    sm, rs = _stream(path, pats, "kmp",
                     attrs={"pipeline_depth": 1 if depth == "reached" else 64})
    for p, r in zip(pats, rs):
        want = find_all(data, p)
        assert r.count == len(want) and r.offsets_list() == want, p
        assert not r.overflow
    assert len(packed) == sm.last_stats["chunks"] == 18
    waited = sm.last_stats["enqueue_wait_s"]
    assert (waited > 0.2) if depth == "reached" else (waited < 0.1), waited


def test_stream_on_card_resume_and_drain(cuda_device, stream_file, tmp_path):
    """Stopped after 5 chunks and resumed: the same journal and manifest as
    an uninterrupted run; drain=True past capacity returns every offset."""
    path, data = stream_file
    full = str(tmp_path / "full.json")
    _, r_full = _stream(path, STREAM_PAT, "rabin_karp", manifest_path=full)

    class Stopped(StreamingMatcher):
        def _iter_chunks(self, *args):
            for item in super()._iter_chunks(*args):
                if item[0] >= 5:
                    return
                yield item

    part = str(tmp_path / "part.json")
    Stopped(STREAM_PAT, "rabin_karp", STREAM_CFG, STREAM_CHUNK, part,
            device="cuda").match_file(path)
    _, r = _stream(path, STREAM_PAT, "rabin_karp", manifest_path=part, resume=True)
    assert r.offsets_list() == r_full.offsets_list() == find_all(data, STREAM_PAT)
    with open(full + ".offsets", "rb") as f, open(part + ".offsets", "rb") as g:
        assert f.read() == g.read()
    assert json.load(open(full)) == json.load(open(part))
    sm, r = _stream(path, b"e ", "boyer_moore", STREAM_CFG.replace(capacity=256),
                    drain=True)
    want = find_all(data, b"e ")
    assert r.offsets_list() == want and not r.overflow
    per_chunk = np.bincount(np.array(want) // STREAM_CHUNK)
    assert sm.last_stats["drained_slots"] == int((per_chunk > 256).sum()) >= 17


# -- the sharded paths -------------------------------------------------------


def test_sharded_paths_on_a_one_rank_nccl_group(cuda_device, stream_file):
    """``match_distributed`` of every algorithm under both gathers, a
    Rabin-Karp group and a drain, ``match_multihost`` and
    ``match_multihost_streaming``, and the int64 gathers, through a one-rank
    NCCL group on the card (collectives issued at world 1; the multi-host
    paths return before theirs, as in the reference)."""
    import torch.distributed as dist

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel import (
        multihost,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.mesh import (
        make_data_mesh,
    )

    path, data = stream_file
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_data_mesh()
        assert (mesh.world, mesh.device.type, dist.get_backend()) == (
            1, "cuda", "nccl")
        want = find_all(data, STREAM_PAT)
        for algo, kernel in STREAM_SCAN.items():
            for mode in ("count_sized", "fixed"):
                before = kernel.launches
                r = match_distributed(data, STREAM_PAT, algo=algo, mesh=mesh,
                                      config=STREAM_CFG.replace(dist_gather=mode))
                assert (r.algo, r.count, r.offsets_list(), r.overflow) == (
                    f"{algo}@mesh1", len(want), want, False)
                assert kernel.launches > before, (algo, mode)
        pats = [STREAM_PAT, b"lazy dog and cat"]
        k6 = rk_roll.rk_candidate_pmask.launches
        rs = match_distributed(data, pats, algo="rabin_karp", mesh=mesh,
                               config=STREAM_CFG)
        assert rk_roll.rk_candidate_pmask.launches > k6
        for p, r in zip(pats, rs):
            assert r.algo == "rabin_karp_multi@mesh1"
            assert r.offsets_list() == find_all(data, p)
        r = match_distributed(data, b"e ", mesh=mesh, drain=True,
                              config=STREAM_CFG.replace(capacity=256))
        assert r.offsets_list() == find_all(data, b"e ") and not r.overflow
        r = match_multihost(path, STREAM_PAT, config=STREAM_CFG)
        assert r.algo == "boyer_moore@hosts1" and r.offsets_list() == want
        r = match_multihost_streaming(path, STREAM_PAT, config=STREAM_CFG,
                                      chunk_bytes=STREAM_CHUNK)
        assert r.algo == "boyer_moore@stream" and r.offsets_list() == want
        big = np.array([2**40 + 3, 2**62 + 5, -1], np.int64)
        assert np.array_equal(multihost.allgather_i64(big, mesh), big[None])
        assert np.array_equal(multihost.allgather_ragged_i64(big[:2], mesh),
                              big[:2])
    finally:
        dist.destroy_process_group()


# -- utils/profiling.py, utils/native.py and the command line on the card ----


def test_timed_and_device_stats_on_a_card_match(cuda_device):
    """``timed`` and ``device_stats`` of ``match`` on the card: the output
    equals the oracle, K1 ran once per call, the profiler saw the card's
    events and the idle share lies in [0, 1]."""
    import functools

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
        profiling,
    )

    text = bytes(gen_english(4 << 20, seed=23))
    pat = b"quick brown fox "
    fn = functools.partial(match, device=cuda_device)
    secs, r = profiling.timed(fn, text, pat, iters=3)
    assert secs > 0 and r.offsets_list() == find_all(text, pat)
    k1 = swar.screen_cand_bsums.launches
    stats = profiling.device_stats(fn, text, pat, runs=3)
    assert swar.screen_cand_bsums.launches == k1 + 4  # the warm call and 3 runs
    assert stats["device"] == torch.cuda.get_device_name(0)
    assert stats["device_ms"] > 0 and stats["device_events"] >= 1
    assert 0 < stats["busy_ms"] <= stats["wall_ms"]
    assert 0 <= stats["idle_share"] <= 1 and stats["peak_bytes"] >= len(text)
    assert 1 <= len(stats["top_events"]) <= 6
    assert 0 < sum(stats["top_events"].values()) <= stats["device_ms"] + 1e-9
    assert stats["argument_size_bytes"] == len(text) + len(pat)
    assert stats["output_size_bytes"] == 8 * r.count + len(pat)


def test_card_timers_time_a_kernel(cuda_device):
    """The timers moved from ``chip_smoke.py`` on K3: CUDA events, the host
    clock, its own device time by name, and device time per run."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
        profiling,
    )

    words, limit, P, M = _region(4 * TILE, b"quick brown fox ", cuda_device)
    fn = lambda: swar.naive_bsums(words, limit, P, M)  # noqa: E731
    assert profiling.cuda_ms(fn, 5) > 0
    assert all(t > 0 for t in profiling.host_ms(fn, 3, passes=2))
    t, seen = profiling.kernel_device_ms(fn, 5, "naive_kernel", swar.naive_bsums)
    assert t > 0 and 1 <= seen <= 5
    dev_ms, per_run, split = profiling.device_profile(fn, 5)
    assert dev_ms > 0 and per_run >= 1 and any("naive_kernel" in k for k in split)
    with pytest.raises(ValueError, match="CPU tensors"):
        profiling.cuda_ms(lambda: torch.ones(4), 2)


def test_native_reader_fills_a_pinned_buffer(cuda_device, tmp_path):
    """``NativeFile.read_chunk`` into the numpy view of a pinned tensor,
    copied to the card."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
        native,
    )

    if native.load() is None:
        pytest.skip("native library unavailable")
    data = bytes(gen_english(1 << 20, seed=3))
    p = tmp_path / "c.bin"
    p.write_bytes(data)
    host = torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
    with native.NativeFile(str(p)) as f:
        _buf, got = f.read_chunk(0, 1 << 20, host.numpy())
    assert got == len(data)
    assert host.to(cuda_device, non_blocking=True).cpu().numpy().tobytes() == data


def test_command_line_on_the_card(cuda_device, tmp_path, capsys):
    """``cli.main`` with its default device runs K1 for the default
    ``bm`` and prints the oracle's count and offsets."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import cli

    data = bytes(gen_english(4 << 20, seed=29))
    p = tmp_path / "c.bin"
    p.write_bytes(data)
    k1 = swar.screen_cand_bsums.launches
    assert cli.main(["bm", str(p), "quick brown fox ", "--json", "--offsets", "-1"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert swar.screen_cand_bsums.launches == k1 + 1
    want = find_all(data, b"quick brown fox ")
    assert (row["count"], row["offsets"], row["algo"]) == (len(want), want, "boyer_moore")


@pytest.mark.parametrize("case", ["bm", "rk_list"])
def test_spans_on_the_card(case, cuda_device):
    """``run`` of 16 MiB under torch.profiler with the card's activity:
    no device event is a ``tpumatch.`` span (a ``cpu_op``, which the
    profiler does not project onto the card's timeline), and every kernel
    launch of the call lies inside some ``tpumatch.`` span."""
    text = bytes(gen_english(16 << 20, seed=31))
    n = len(text)
    if case == "bm":
        pats = [b"quick brown fox "]
        m = BoyerMooreMatcher(pats[0], device=cuda_device)
        mult = m._pad_target(n)
    else:
        pats = [b"quick brown fox ", b"lazy dog and cat", b"parallel device "]
        m = RabinKarpMultiMatcher(pats, device=cuda_device)
        mult = 128 * m.config.pallas_chunk_bytes
    dev_text = torch.from_numpy(
        pad_to_multiple(np.frombuffer(text, np.uint8), mult)).to(cuda_device)
    m.run(dev_text, n)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = m.run(dev_text, n)
        torch.cuda.synchronize()
    out = [out] if case == "bm" else out
    for (count, offs, _ovf), pat in zip(out, pats):
        want = find_all(text, pat)
        assert (count, offs.cpu().tolist()) == (len(want), want)
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    assert not [e.name() for e in events if e.device_type() == cuda
                and e.name().startswith("tpumatch.")]
    assert any(e.device_type() == cuda for e in events)
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.device_type() != cuda and e.name().startswith("tpumatch.")]
    launches = [e for e in events if e.device_type() != cuda
                and "LaunchKernel" in e.name()]
    assert spans and launches
    for e in launches:
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        assert any(a <= lo and hi <= b for a, b in spans), e.name()
