"""PyTorch port, multi-pattern Rabin-Karp: the plain K6
(``rk_roll.rk_candidate_pmask``) against the Pallas kernel it replaces in
interpret mode, ``rk_multi_start_masks`` and the multi matcher's tables
against the JAX package, and ``match(text, [patterns])`` against the JAX
``match`` / ``RabinKarpMultiMatcher`` and the oracle.  Tolerance: exact
integer equality everywhere.

K6's inclusion rule: the reference's per-block pattern masks are a
superset of the port's (its end-word fold reaches a few bytes into the
neighbouring blocks, and each TPU sub-chunk rolls cold over zero front
padding), and the port's are a superset of the blocks holding true starts:
Pallas ⊇ port ⊇ true starts, bit for bit.  The port's mask equals the
numpy statement of its definition: bit p of block b is set when some start
s in b with s <= n_lim hashes to pattern p.

Capacity is per pattern in the port; where the reference reports
``overflow=True`` the rule is counts equal, offsets an ascending prefix of
the oracle's.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match as jmatch,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    rk_roll as jrk_roll,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.multi import (
    RabinKarpMultiMatcher as JaxMulti,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    rabin_karp as jrk,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    reconstruct as jreconstruct,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_binary,
    gen_dna,
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    api,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    shift_and,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    RabinKarpMatcher,
    tables_from_reference,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    rabin_karp as rk_ops,
)

CHUNK = 4096
TILE = 128 * CHUNK  # 512 KiB
SUB = CHUNK // 8    # the reference's 512-byte sub-chunk
BASE = int(jtables.RK_BASE)
# n against the region end Nk (tests/test_torch_scan_kernels.py's cases).
N_CASES = {
    "n=Nk-1": (TILE - 1, TILE),
    "n=Nk": (TILE, TILE),
    "n=Nk+3000": (TILE + 3000, 4096),
    "2tiles": (2 * TILE - 777, TILE),
}
PCFG = MatchConfig(pallas_chunk_bytes=CHUNK, capacity=4096,
                   verify_capacity=4096)
JCFG = jconfig.MatchConfig(use_pallas="off", pallas_chunk_bytes=CHUNK,
                           capacity=4096, verify_capacity=4096,
                           pad_multiple=4096)


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


def _planted(n: int, plants, seed: int) -> bytes:
    data = bytearray(gen_english(n, seed=seed))
    for off, p in plants:
        if 0 <= off <= n - len(p):
            data[off : off + len(p)] = p
    return bytes(data)


def _hashes(pats, m: int) -> np.ndarray:
    c = jtables.rk_constants(m, BASE)
    return np.array([jtables.rk_hash(_u8(p), c) for p in pats], np.uint32)


def _numpy_pmask(region: np.ndarray, pats, n_lim: int) -> np.ndarray:
    """K6 by its definition: Horner window hashes in wrapping uint32, then
    per pattern, any hit at a start s <= n_lim, per 512-byte block."""
    m, N = len(pats[0]), len(region)
    x = np.concatenate([region, np.zeros(m, np.uint8)]).astype(np.uint32)
    h = np.zeros(N, np.uint32)
    for j in range(m):
        h = h * np.uint32(BASE) + x[j : j + N]
    valid = np.arange(N) <= n_lim
    pm = np.zeros(N // 512, np.int64)
    for p, t in enumerate(_hashes(pats, m)):
        pm |= ((h == t) & valid).reshape(-1, 512).any(1).astype(np.int64) << p
    return pm


def _true_pmask(region: bytes, pats, n_lim: int) -> np.ndarray:
    pm = np.zeros(len(region) // 512, np.int64)
    for p, pat in enumerate(pats):
        for s in find_all(region, pat):
            if s <= n_lim:
                pm[s // 512] |= 1 << p
    return pm


# (k, m, n case, patterns, plants): the config-2 shape (k=8, m=16) with
# corpus-drawn and synthetic patterns, the k=31 bit boundary (bit 30), the
# kernel bounds m=509 and m=2, and a NUL-leading pattern whose tail is
# planted at sub-chunk starts, where the reference's cold roll over zero
# front padding sets bits that the port's exact rule does not.
def _pmask_case(name: str):
    if name == "k8-m16":
        n, pad = N_CASES["n=Nk"]
        base_text = gen_english(n, seed=201)
        pats = [b"quick brown fox ", b"lazy dog and cat", b"parallel device ",
                b"search algorithm", base_text[1000:1016],
                base_text[n // 2 : n // 2 + 16], base_text[n // 3 : n // 3 + 16],
                base_text[n - 4096 : n - 4080]]
        plants = [(SUB - 7, pats[0]), (CHUNK - 3, pats[1]), (TILE - 16, pats[2]),
                  (3 * SUB + 2, pats[0]), (3 * SUB + 40, pats[3])]
        return n, pad, pats, plants, 201
    if name == "k31-m12":
        n, pad = N_CASES["2tiles"]
        pats = [bytes(gen_english(12, seed=3100 + i)) for i in range(31)]
        plants = [(100, pats[0]), (SUB * 9 + 5, pats[30]), (SUB * 20 + 3, pats[0]),
                  (SUB * 20 + 60, pats[30]), (TILE - 6, pats[30]),
                  (2 * TILE - 777 - 12, pats[15])]
        return n, pad, pats, plants, 202
    if name == "k2-m509":
        n, pad = N_CASES["n=Nk+3000"]
        text = gen_english(n, seed=203)
        pats = [text[5000:5509], bytes(gen_english(509, seed=2031))]
        plants = [(SUB - 100, pats[1]), (TILE - 509, pats[0])]
        return n, pad, pats, plants, 203
    if name == "k1-m2":
        n, pad = N_CASES["n=Nk-1"]
        return n, pad, [b"qz"], [(SUB - 1, b"qz"), (TILE - 3, b"qz")], 204
    assert name == "nul-lead"
    n, pad = N_CASES["n=Nk"]
    pats = [b"\x00abc", b"abcd", b"\x00\x00zq"]
    plants = [(SUB * j, b"abc") for j in (3, 17, 40)] + [
        (SUB * 50, b"zq"), (SUB * 60 + 9, b"abcd")]
    return n, pad, pats, plants, 205


@pytest.mark.parametrize("name", ["k8-m16", "k31-m12", "k2-m509", "k1-m2",
                                  "nul-lead"])
def test_pmask_plain_between_pallas_and_true_starts(name):
    n, pad, pats, plants, seed = _pmask_case(name)
    m = len(pats[0])
    padded = pad_to_multiple(_u8(_planted(n, plants, seed)), pad)
    Nk, cut = shift_and.kernel_region(len(padded), m, CHUNK)
    n_lim = min(n, Nk) - m
    region = padded[:Nk]
    words = torch.from_numpy(region.view(np.int32).copy())
    targets = torch.from_numpy(_hashes(pats, m).astype(np.int64))
    before = rk_roll.rk_candidate_pmask.launches
    port = rk_roll.rk_candidate_pmask(words, n_lim, targets, m, BASE)
    assert rk_roll.rk_candidate_pmask.launches == before  # CPU: plain version
    assert port.dtype == torch.int32 and port.shape == (Nk // 512,)
    ref, cut_ref = jrk_roll.rk_candidate_bsums(
        jnp.asarray(padded), n, _hashes(pats, m), m, BASE, chunk_bytes=CHUNK,
        interpret=True, words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024)),
        emit="pmask")
    assert cut_ref == cut
    ref = np.asarray(ref).astype(np.int64)
    got = port.numpy().astype(np.int64)
    true = _true_pmask(region.tobytes(), pats, n_lim)
    assert np.array_equal(got, _numpy_pmask(region, pats, n_lim))
    assert np.array_equal(ref & got, got)      # Pallas ⊇ port
    assert np.array_equal(got & true, true)    # port ⊇ true starts
    assert int(np.count_nonzero(true)) > 0
    if name == "k31-m12":
        assert all(true[b] >> 30 & 1 for b in (9, 20))  # bit 30 set
    if name == "nul-lead":  # the reference's zero-prefixed windows
        for j in (3, 17, 40):
            assert ref[j] & 1 and not got[j] & 1


def test_pmask_equals_any_of_bsums_and_rejects_bad_k():
    """K6's mask is nonzero exactly where K5's count over the same targets
    is; more than 31 targets do not fit a mask."""
    text = _planted(TILE, [(7, b"the quick"), (TILE - 9, b"lazy dogs")], 9)
    words = torch.from_numpy(_u8(text).view(np.int32).copy())
    pats = [b"the quick", b"lazy dogs", b" and the "]
    tgt = torch.from_numpy(_hashes(pats, 9).astype(np.int64))
    pm = rk_roll.rk_candidate_pmask(words, TILE - 9, tgt, 9, BASE)
    bs = rk_roll.rk_candidate_bsums(words, TILE - 9, tgt, 9, BASE)
    assert torch.equal(pm != 0, bs != 0) and int((pm != 0).sum()) >= 2
    assert int(pm[0]) & 1 and int(pm[-1]) & 2
    many = torch.arange(32, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most 31"):
        rk_roll.rk_candidate_pmask(words, TILE - 9, many, 9, BASE)
    assert rk_roll.rk_candidate_pmask(words, TILE - 9, many[:31], 9, BASE).shape == pm.shape
    for bad in ((words, TILE, tgt.to(torch.int32), 9, BASE),
                (words, TILE, tgt, 510, BASE), (words, TILE, tgt, 9, 2),
                (words[:100], TILE, tgt, 9, BASE)):
        with pytest.raises((TypeError, ValueError)):
            rk_roll.rk_candidate_pmask(*bad)


# -- match(text, [patterns]) against the JAX package and the oracle ----------


def check_many(text, pats, jcfg=JCFG, pcfg=PCFG, jax_ref=True, **kw):
    """Port list match vs the oracle and (unless ``jax_ref`` is False) the
    JAX ``match``; returns the port results."""
    raw = text.encode() if isinstance(text, str) else bytes(text)
    rs = match(text, pats, config=pcfg, device="cpu", **kw)
    js = jmatch(text, pats, config=jcfg, **kw) if jax_ref else [None] * len(pats)
    assert len(rs) == len(pats)
    cap, drained = pcfg.capacity, kw.get("drain", False)
    for p, r, j in zip(pats, rs, js):
        pb = p.encode() if isinstance(p, str) else p
        want = find_all(raw, pb)
        assert r.pattern == pb and r.count == len(want), (pb, r.count, len(want))
        assert r.overflow == (len(want) > cap and not drained), pb
        assert r.offsets_list() == (want if drained else want[:cap]), pb
        if j is not None:
            assert j.count == r.count, pb
            if not j.overflow:
                assert r.offsets_list() == j.offsets_list(), pb
    return rs


# The plants of the JAX package's test_rk_multi_gather_modes_parity:
# duplicate patterns (both bits on every shared block), two and three
# patterns in one block, overlapping matches, block and tile seams, and a
# match at the end of the kernel region.
GATHER_N = TILE + 999
GATHER_PATS = [b"QXZRVKWJ", b"ZZQQWWEE", b"abcdabcd", b"the quic", b"QXZRVKWJ"]
GATHER_PLANTS = [
    (100, GATHER_PATS[0]), (132, GATHER_PATS[0]),
    (512 * 10 + 3, GATHER_PATS[1]), (512 * 10 + 11, GATHER_PATS[1]),
    (512 * 20 + 1, GATHER_PATS[2]), (512 * 20 + 9, GATHER_PATS[2]),
    (512 * 20 + 17, GATHER_PATS[2]), (512 * 30 - 4, GATHER_PATS[3]),
    (512 * 40 + 28, GATHER_PATS[0]), (GATHER_N - 999 - 16, GATHER_PATS[1]),
    (512 * 50 + 64, b"abcdabcdabcd"),
    (512 * 60 + 5, GATHER_PATS[0]), (512 * 60 + 40, GATHER_PATS[1]),
    (512 * 61 + 500, GATHER_PATS[2]), (512 * 62 + 2, GATHER_PATS[3]),
    (512 * 70 + 3, GATHER_PATS[0]), (512 * 70 + 100, GATHER_PATS[1]),
    (512 * 70 + 300, GATHER_PATS[2]),
]


@pytest.mark.parametrize("mg", ["pselect", "blocks", "groups"])
def test_multi_gather_modes_planted(mg):
    text = _planted(GATHER_N, GATHER_PLANTS, 88)
    rs = check_many(text, GATHER_PATS, algo="rabin_karp",
                    pcfg=PCFG.replace(multi_gather=mg),
                    jcfg=JCFG.replace(multi_gather=mg))
    assert all(r.algo == "rabin_karp_multi" and not r.overflow for r in rs)
    assert rs[0].offsets_list() == rs[4].offsets_list() and rs[0].count >= 5
    assert rs[2].offsets_list()[:4] == [512 * 20 + 1, 512 * 20 + 5,
                                        512 * 20 + 9, 512 * 20 + 13]


def test_pselect_against_pallas_interpret_reference():
    """The reference with its Pallas kernels in interpret mode (K6's pmask
    and the pattern-selected extraction) against the port."""
    text = _planted(GATHER_N, GATHER_PLANTS, 88)
    jcfg = JCFG.replace(use_pallas="on", interpret=True)
    js = JaxMulti(GATHER_PATS, jcfg).match(text)
    before = rk_roll.rk_candidate_pmask.launches
    rs = RabinKarpMultiMatcher(GATHER_PATS, PCFG, device="cpu").match(text)
    assert rk_roll.rk_candidate_pmask.launches == before
    for p, r, j in zip(GATHER_PATS, rs, js):
        assert not j.overflow and (r.count, r.offsets_list()) == (
            j.count, j.offsets_list()) == (len(find_all(text, p)), find_all(text, p))


def test_multi_pattern_64_groups_exact():
    """k = 64 > 31 takes the K5 block-sum screen over all 64 targets (the
    reference runs groups of 31 on it).  Against the oracle, as the JAX
    test does: the reference's 64-pattern jnp route takes ~15 s to
    compile here."""
    data = bytearray(gen_english(2 * TILE + 300, seed=13))
    pats = [f"P{i:02d}pattern64".encode() for i in range(60)]
    pats += [bytes(data[i * 7919 : i * 7919 + 12]) for i in range(4)]
    for i, pos in ((0, 0), (1, CHUNK - 5), (2, TILE), (3, 2 * TILE + 288),
                   (40, 777), (59, TILE - 6)):
        data[pos : pos + 12] = pats[i]
    text = bytes(data)
    rs = check_many(text, pats, algo="rabin_karp", jax_ref=False)
    assert sum(r.count for r in rs) >= 10


@pytest.mark.parametrize("rescan", [False, True], ids=["gather", "rescan"])
def test_rk_multi_dense_union_tiers_and_truncation(rescan, monkeypatch):
    """Dense m=2 digraphs over the kernel region, the port through the
    decode, the reference through its plain jnp route and (its Pallas
    route interpreted, its gather width shrunk) through its selector's K2
    rescan: exact at a large capacity; at a small one, counts exact,
    offsets the oracle's first ``capacity`` per pattern, overflow set
    where the count exceeds it."""
    jcfg = JCFG
    if rescan:
        monkeypatch.setattr(jreconstruct, "SPARSE_CHUNKS_SMALL", 32)
        jcfg = JCFG.replace(use_pallas="on", interpret=True)
    text = gen_english(TILE + 99, seed=83)
    pats = [b"e ", b" t", b"th", b"qq"]
    expected = [find_all(text, p) for p in pats]
    assert sum(len(e) for e in expected) > 8192
    check_many(text, pats, algo="rabin_karp", pcfg=PCFG.replace(capacity=65536),
               jcfg=jcfg.replace(capacity=65536))
    rs = check_many(text, pats, algo="rabin_karp",
                    pcfg=PCFG.replace(capacity=1024),
                    jcfg=jcfg.replace(capacity=1024))
    assert [r.overflow for r in rs] == [len(e) > 1024 for e in expected]
    assert sum(r.overflow for r in rs) >= 2
    k2 = swar.naive_nib.launches  # CPU tensors: never a launch
    assert (k2, rk_roll.rk_candidate_pmask.launches) == (
        swar.naive_nib.launches, rk_roll.rk_candidate_pmask.launches)


def test_multi_sparse_truncation_flagged():
    """A rare pattern beside a dense one: with per-pattern capacity the
    rare one comes out complete, the dense one truncated and flagged."""
    data = bytearray(gen_english(2 * TILE + 55, seed=99))
    p_dense, p_rare = b"DENSEPT!", b"RAREPAT?"
    for blk in range(0, len(data) - 8, 512):
        data[blk : blk + 8] = p_dense
    data[2 * TILE - 900 : 2 * TILE - 892] = p_rare
    text = bytes(data)
    cfg = PCFG.replace(capacity=1024)
    rs = check_many(text, [p_dense, p_rare], algo="rabin_karp", pcfg=cfg,
                    jcfg=JCFG.replace(capacity=1024))
    assert rs[0].overflow and rs[0].count > 1024
    assert rs[1].offsets_list() == [2 * TILE - 900] and not rs[1].overflow


def test_pselect_many_multibit_blocks_fallback():
    """2500 blocks carrying three bits (one pattern tripled) plus a rare
    pattern: every result exact, none overflowing."""
    n = 4 * TILE
    p, q = b"QZXWVKYJMRTN", b"ABLKWQPZTRVU"
    text = _planted(n, [(b * 512 + 7, p) for b in range(2500)]
                    + [(512 * 3000 + 5, q)], 4242)
    cfg = PCFG.replace(capacity=8192, verify_capacity=8192)
    rs = check_many(text, [p, p, p, q], algo="rabin_karp", pcfg=cfg,
                    jax_ref=False)
    assert [r.count for r in rs] == [2500, 2500, 2500, 1]


def test_pselect_k31_bit_boundary():
    n = TILE + 777
    pats = [bytes(gen_english(12, seed=3100 + i)) for i in range(31)]
    text = _planted(n, [(100, pats[0]), (512 * 9 + 5, pats[30]),
                        (512 * 20 + 3, pats[0]), (512 * 20 + 60, pats[30])], 31)
    rs = check_many(text, pats, algo="rabin_karp", jax_ref=False)
    assert rs[30].count >= 2 and rs[0].count >= 2


def test_mixed_lengths_other_algorithms_and_drain():
    """Length groups (a group of one runs the single-pattern matcher), str
    patterns as UTF-8, every algorithm per pattern, drain per pattern."""
    text = _planted(TILE + 5000, [(77, b"quick brown fox "), (TILE - 3, b"lazy")],
                    11)
    pats = [b"quick brown fox ", "lazy", b"the ", b"fox jumps over l", b"e",
            b"and "]
    rs = check_many(text, pats, algo="rk")
    assert [r.algo for r in rs] == ["rabin_karp_multi", "rabin_karp_multi",
                                    "rabin_karp_multi", "rabin_karp_multi",
                                    "rabin_karp", "rabin_karp_multi"]
    for algo in ("boyer_moore", "naive", "kmp"):
        assert {r.algo for r in check_many(text, pats[:3], algo=algo)} == {algo}
    rs = check_many(text, [b"e ", b"th"], algo="rabin_karp", drain=True,
                    pcfg=PCFG.replace(capacity=1024), jcfg=JCFG.replace(capacity=1024))
    assert all(r.algo == "rabin_karp" and r.count > 1024 for r in rs)
    assert match(text, [], device="cpu") == []


@pytest.mark.parametrize("alphabet", ["binary", "dna", "english"])
@pytest.mark.parametrize("mg", ["pselect", "blocks", "groups"])
def test_fuzz_multi_pattern(mg, alphabet):
    """Seeded fuzz over the three modes (the JAX package's multi-gather
    fuzz, on the kernel path): k patterns drawn from the text, so
    repetitive corpora put several patterns in one block, plus same-block,
    seam and end plants and a small capacity; against the oracle and the
    JAX package."""
    rng = np.random.default_rng(10 * len(alphabet) + len(mg))
    gen = {"binary": gen_binary, "dna": gen_dna, "english": gen_english}[alphabet]
    n = TILE + int(rng.integers(0, 3 * 4096))
    m = int(rng.integers(2, 25))
    k = int(rng.integers(2, 9))
    text = bytearray(gen(n, seed=int(rng.integers(1 << 20))))
    pats = [bytes(text[p0 : p0 + m]) for p0 in rng.integers(0, n - m, size=k)]
    for j, off in enumerate((512 * 3 + 1, 512 * 3 + 40, 512 * 3 + 90, 0,
                             TILE - m // 2, n - m)):
        text[off : off + m] = pats[j % k]
    cap = int(rng.integers(16, 4096))
    check_many(bytes(text), pats, algo="rabin_karp",
               pcfg=PCFG.replace(multi_gather=mg, capacity=cap),
               jcfg=JCFG.replace(multi_gather=mg, capacity=cap))


@pytest.mark.parametrize("m", [1, 16, 510])
def test_mask_route_short_text_and_kernel_bounds(m):
    """Texts shorter than a tile, m = 1 and m > 509 take the plain masks
    over the whole text."""
    base = gen_english(3 * 4096 + 11, seed=m)
    pats = [base[40 : 40 + m], base[900 : 900 + m], b"\xfe" * m]
    check_many(base, pats, algo="rabin_karp")
    long = _planted(TILE + 100, [(TILE - m // 2, pats[0])], m)
    check_many(long, pats, algo="rabin_karp", jax_ref=m == 1)


def test_nul_patterns_never_match_padding():
    n = TILE + 100
    data = bytearray(_planted(n, [(1000, b"ab\x00\x00"), (TILE + 17, b"cd\x00\x00")], 3))
    data[-2:] = b"ab"  # "ab" + zero padding would match b"ab\0\0"
    rs = check_many(bytes(data), [b"ab\x00\x00", b"cd\x00\x00", b"\x00\x00\x00\x00"],
                    algo="rabin_karp")
    assert rs[0].offsets_list() == [1000]


# -- ops, tables and construction ---------------------------------------------


@pytest.mark.parametrize("m,vcap", [(1, 4), (4, 131072), (16, 4), (509, 131072)])
def test_rk_multi_start_masks_equal_reference(m, vcap):
    text = _u8(gen_english(6000, seed=m))
    pats = np.stack([text[100 : 100 + m], text[3000 : 3000 + m], text[100 : 100 + m],
                     np.full(m, 0xFE, np.uint8)])
    c = jtables.rk_constants(m, None)
    hashes = np.array([jtables.rk_hash(p, c) for p in pats], np.uint32)
    got = rk_ops.rk_multi_start_masks(
        torch.from_numpy(text.copy()), torch.from_numpy(pats),
        torch.from_numpy(c["powers"].astype(np.int64)),
        torch.from_numpy(hashes.astype(np.int64)), vcap)
    want = np.asarray(jrk.rk_multi_start_masks(
        jnp.asarray(text), jnp.asarray(pats), jnp.asarray(c["powers"]),
        jnp.asarray(hashes), vcap))
    assert got.dtype == torch.bool and got.shape == (4, 6000)
    assert np.array_equal(got.numpy(), want)
    assert np.flatnonzero(want[1]).tolist() == find_all(text.tobytes(), pats[1].tobytes())


@pytest.mark.parametrize("base", [None, 0x9E3779B1])
def test_tables_equal_reference_and_round_trip(base):
    pats = [b"quick brown fox ", b"lazy dog and cat", b"ab\x00\x00cdefghijklmn"]
    jm = JaxMulti(pats, jconfig.MatchConfig(rk_base=base))
    pm = RabinKarpMultiMatcher(pats, MatchConfig(rk_base=base), device="cpu")
    assert pm.tables.keys() == jm.tables.keys() == {"powers", "hashes", "swar_ps"}
    dev = tables_from_reference(jm.tables, None, "cpu")
    for k, v in jm.tables.items():
        assert np.array_equal(pm.tables[k], v) and pm.tables[k].dtype == v.dtype, k
        assert torch.equal(dev[k], pm.dev_tables[k]), k
    assert dev["hashes"].dtype == dev["powers"].dtype == torch.int64
    assert dev["swar_ps"].dtype == torch.int32 and dev["swar_ps"].shape[:2] == (3, 4)
    assert np.array_equal(pm.pattern_arr, jm.pattern_arr)
    # The port runs on the reference's tables.
    text = _planted(TILE + 9, [(5, pats[0]), (TILE - 16, pats[1])], 12)
    pm.dev_tables = dev
    rs = pm.match(text)
    assert [r.offsets_list() for r in rs] == [find_all(text, p) for p in pats]


def test_constructor_errors_groups_mode_and_cache():
    with pytest.raises(ValueError, match="no patterns"):
        RabinKarpMultiMatcher([], device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        RabinKarpMultiMatcher([b"ab", b"abc"], device="cpu")
    with pytest.raises(ValueError, match="empty"):
        RabinKarpMultiMatcher([b"", b""], device="cpu")
    assert [r.offsets_list() for r in match(
        b"abcxyzabc", [b"abc", b"xyz"], algo="rk", device="cpu",
        multi_gather="groups")] == [[0, 6], [3]]
    with pytest.raises(ValueError):
        MatchConfig(multi_gather="union")
    pats = [b"abc", b"xyz"]
    match(b"abcxyz", pats, algo="rk", device="cpu")
    key = ("rabin_karp_multi", tuple(pats), MatchConfig(), "cpu")
    mm = api._matcher_cache[key]
    assert isinstance(mm, RabinKarpMultiMatcher) and mm.device.type == "cpu"
    rs = match(b"abcxyz", pats, algo="rk", device="cpu")
    assert api._matcher_cache[key] is mm
    assert [r.offsets_list() for r in rs] == [[0], [3]]


def test_run_returns_the_stacked_per_pattern_contract():
    """``run`` on a device-resident padded text: k (count, offsets,
    overflow) triples in pattern order, as ``Matcher.run`` returns one."""
    pats = [b"quick brown fox ", b"lazy dog and cat", b"never in corpus!"]
    text = _planted(2 * TILE + 77, [(3, pats[0]), (TILE - 8, pats[0]),
                                    (2 * TILE + 50, pats[1])], 77)
    mm = RabinKarpMultiMatcher(pats, PCFG, device="cpu")
    padded = pad_to_multiple(_u8(text), 2 * TILE)
    out = mm.run(torch.from_numpy(padded.copy()), len(text))
    single = [RabinKarpMatcher(p, PCFG, device="cpu").run(
        torch.from_numpy(padded.copy()), len(text)) for p in pats]
    assert len(out) == 3
    for (c, o, v), (c1, o1, v1), p in zip(out, single, pats):
        assert isinstance(c, int) and o.dtype == torch.int64 and not v
        assert (c, o.tolist()) == (c1, o1.tolist()) == (
            len(find_all(text, p)), find_all(text, p))
