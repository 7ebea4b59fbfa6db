"""PyTorch port: the last opt-in routes against the JAX package, on the CPU.
Tolerance: exact integer equality everywhere.

- K9, the Shift-AND kernel's composed-4 step and compare-B lookup
  (``shift_and.kmp_bsums`` / ``kmp_nib`` under ``STEP_PATH`` and
  ``pat_key``): their plain versions against the Pallas kernel in
  interpret mode with the reference's ``STEP_PATH = "composed"`` and ``pat_key``, at K = 1 (K > 1
  costs minutes interpreted; it is held on the card);
- K10c, ``rk_roll.rk_candidate_bmask``: the plain version against the
  Pallas ``emit='bmask'``;
- ``multi_gather='groups'``: ``reconstruct.extract_region_multi_groups``
  and ``match`` against the JAX ``RabinKarpMultiMatcher`` and the oracle,
  and its edges (m = 33 and 34, k > 31, the gather-width fallback, a
  capacity overflow);
- ``bm_variant='cursor'``: ``ops/boyer_moore.bm_start_mask_cursor`` against
  the JAX function on the same tables, and ``match`` against the JAX
  ``match`` and the oracle.

The geometry is ``tests/test_torch_scan_kernels.py``'s: a 4096-byte chunk,
a 512 KiB tile and 512-byte sub-chunks, with matches planted across those
seams, at the cut and at the last valid start.
"""

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
    shift_and as jshift_and,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    BoyerMooreMatcher as JaxBM,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.multi import (
    RabinKarpMultiMatcher as JaxMulti,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    boyer_moore as jbm,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    emit as jemit,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    shift_and,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    tables_from_reference,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    boyer_moore as bm_ops,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    reconstruct,
)
from test_torch_multi import GATHER_N, GATHER_PATS, GATHER_PLANTS, JCFG, PCFG, check_many

CHUNK = 4096
TILE = 128 * CHUNK  # 512 KiB
SUB = CHUNK // 8    # the reference's 512-byte sub-chunk
N_CASES = {
    "n=Nk-1": (TILE - 1, TILE),
    "n=Nk": (TILE, TILE),
    "n=Nk+3000": (TILE + 3000, 4096),
    "2tiles": (2 * TILE - 777, TILE),
}
BASE = int(jtables.RK_BASE)


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


def _setup(case: str, pat: bytes, seed: int):
    """(padded text, n, region words, Nk, cut, limit, reference args) with
    ``pat`` planted across sub-chunk, chunk and tile seams, at the cut and
    at the last valid start."""
    n, pad = N_CASES[case]
    m = len(pat)
    Nk = (-(-n // pad) * pad // TILE) * TILE
    offs = (0, SUB - 1, 3 * SUB - m // 2, CHUNK - 2, 7 * CHUNK + SUB - m + 1,
            TILE - m // 2, Nk - m, Nk - m + 1, n // 2 + 3, n - m)
    padded = pad_to_multiple(_u8(_planted(n, [(o, pat) for o in offs], seed)), pad)
    Nk, cut = shift_and.kernel_region(len(padded), m, CHUNK)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    ref = (jnp.asarray(padded),
           dict(chunk_bytes=CHUNK, interpret=True,
                words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024))))
    return padded, n, words, Nk, cut, min(n - m, cut - 1), ref


def _launch_counts():
    return (shift_and.kmp_bsums.launches, shift_and.kmp_nib.launches,
            dict(shift_and.kmp_bsums.k9_launches),
            dict(shift_and.kmp_nib.k9_launches),
            rk_roll.rk_candidate_bmask.launches)


# -- K9 -----------------------------------------------------------------------

# (m, variant, emission, n case): each variant at each m, each variant and
# each m under both emissions.
K9_CASES = [
    (5, "composed", "bsums", "n=Nk-1"), (5, "compare_b", "nib", "n=Nk"),
    (5, "both", "bsums", "n=Nk+3000"),
    (16, "composed", "nib", "n=Nk+3000"), (16, "compare_b", "bsums", "n=Nk-1"),
    (16, "both", "nib", "n=Nk"),
    (32, "composed", "bsums", "n=Nk"), (32, "compare_b", "nib", "n=Nk+3000"),
    (32, "both", "nib", "n=Nk-1"),
]


@pytest.mark.parametrize("m,variant,emission,case", K9_CASES,
                         ids=[f"m{m}-{v}-{e}-{c}" for m, v, e, c in K9_CASES])
def test_k9_plain_matches_pallas(m, variant, emission, case, monkeypatch):
    """The port's wrappers under ``STEP_PATH = "composed"`` and/or ``pat_key``
    (their plain versions on the CPU) equal the Pallas kernel with the
    reference's ``STEP_PATH = "composed"`` and/or ``pat_key``; nibbles after
    the reference's ``nibble_valid``."""
    pat = bytes(gen_english(m, seed=300 + m))
    if m == 32:  # bit 31 of B: the reference's int32 wrap
        pat = pat[:31] + bytes([pat[0]])
    padded, n, words, Nk, cut, limit, (t, kw) = _setup(case, pat, 310 + m)
    u = _u8(pat)
    composed = variant in ("composed", "both")
    pat_key = pat if variant in ("compare_b", "both") else None
    if composed:
        monkeypatch.setattr(jshift_and, "STEP_PATH", "composed")
    monkeypatch.setattr(shift_and, "STEP_PATH", "composed" if composed else "perbyte")
    bt_ref = jnp.asarray(jshift_and.b_table(u))
    bt = torch.from_numpy(shift_and.b_table(u))
    before = _launch_counts()
    if emission == "bsums":
        ref, cut_ref = jshift_and.kmp_bsums(t, n, bt_ref, m, pat_key=pat_key, **kw)
        bs = shift_and.kmp_bsums(words, min(n, Nk) - m, bt, m, pat_key=pat_key)
        assert np.array_equal(bs.numpy(), np.asarray(ref))
        assert torch.equal(bs, shift_and.kmp_bsums_plain(words, min(n, Nk) - m, bt, m))
    else:
        ref, cut_ref = jshift_and.kmp_nib(t, n, bt_ref, m, pat_key=pat_key, **kw)
        nib, bs = shift_and.kmp_nib(words, limit, bt, m, pat_key=pat_key)
        assert np.array_equal(nib.numpy(), np.asarray(jemit.nibble_valid(ref, limit)))
        assert torch.equal(bs, shift_and.kmp_bsums_plain(words, limit, bt, m))
    assert cut_ref == cut
    assert _launch_counts() == before  # CPU tensors: the plain versions
    assert int(bs.sum()) >= 5


def test_k9_wrappers_validate_and_honour_step_path(monkeypatch):
    """``STEP_PATH`` is one of STEP_PATHS, ``pat_key`` holds the m
    pattern bytes; compare-B's tables are the
    pattern's distinct bytes and their B masks, bit 31 wrapped as int32.
    On the CPU every variant returns the plain version's answer and counts
    no launch."""
    pat = b"abcab"
    padded, n, words, Nk, cut, limit, _ = _setup("n=Nk", pat, 7)
    bt = torch.from_numpy(shift_and.b_table(_u8(pat)))
    want = shift_and.kmp_nib_plain(words, limit, bt, 5)
    before = _launch_counts()
    for step in shift_and.STEP_PATHS:
        monkeypatch.setattr(shift_and, "STEP_PATH", step)
        for key in (None, pat):
            got = shift_and.kmp_nib(words, limit, bt, 5, pat_key=key)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert torch.equal(shift_and.kmp_bsums(words, limit, bt, 5, key),
                               want[1])
    assert _launch_counts() == before
    with pytest.raises(ValueError, match="pat_key"):
        shift_and.kmp_nib(words, limit, bt, 5, pat_key=b"abc")
    for bogus in ("composed4", "bogus"):
        monkeypatch.setattr(shift_and, "STEP_PATH", bogus)
        with pytest.raises(ValueError, match="STEP_PATH"):
            shift_and.kmp_bsums(words, limit, bt, 5)
        with pytest.raises(ValueError, match="STEP_PATH"):
            shift_and.kmp_nib(words, limit, bt, 5, pat_key=pat)
    cb, masks = shift_and.compare_tables(b"abca")
    assert cb.tolist() == [97, 98, 99] and masks.tolist() == [0b1001, 0b10, 0b100]
    cb, masks = shift_and.compare_tables(b"x" * 31 + b"y")
    assert masks.tolist() == [(1 << 31) - 1, -(1 << 31)]


def test_kmp_match_under_composed_step_path(monkeypatch):
    """``STEP_PATH = "composed"`` reaches ``match(algo='kmp')`` (sparse, the
    m > 32 screen, and 'nib'); the answer is the oracle's."""
    monkeypatch.setattr(shift_and, "STEP_PATH", "composed")
    text = _planted(TILE + 5000, [(SUB - 3, b"quick brown fox "),
                                  (TILE - 20, b"quick brown fox ")], 17)
    cfg = PCFG.replace(capacity=65536)
    for pat in (b"quick brown fox ", b"the ", text[7000:7064]):
        for emission in ("sparse", "nib"):
            r = match(text, pat, algo="kmp", config=cfg.replace(emission=emission),
                      device="cpu")
            assert r.offsets_list() == find_all(text, pat) and r.count > 0


# -- K10c ---------------------------------------------------------------------


def _true_groups(region: bytes, pats, n_lim: int) -> np.ndarray:
    """Per block, the 32-byte groups holding a true start s <= n_lim."""
    bm = np.zeros(len(region) // 512, np.int64)
    for pat in pats:
        for s in find_all(region, pat):
            if s <= n_lim:
                bm[s // 512] |= 1 << (s % 512 // 32)
    return bm


def test_bmask_plain_matches_pallas():
    """K10c's plain version equals the Pallas ``emit='bmask'`` bit for bit
    on the multi-gather plants (the reference folds END nibbles to starts
    byte-exactly); it is nonzero exactly where K5's count is and holds every
    true start's group."""
    text = _planted(GATHER_N, GATHER_PLANTS, 88)
    m = len(GATHER_PATS[0])
    padded = pad_to_multiple(_u8(text), CHUNK)
    Nk, cut = shift_and.kernel_region(len(padded), m, CHUNK)
    n_lim = min(len(text), Nk) - m
    words = torch.from_numpy(padded[:Nk].view(np.int32).copy())
    c = jtables.rk_constants(m, BASE)
    h = np.array([jtables.rk_hash(_u8(p), c) for p in GATHER_PATS], np.uint32)
    tgt = torch.from_numpy(h.astype(np.int64))
    before = _launch_counts()
    got = rk_roll.rk_candidate_bmask(words, n_lim, tgt, m, BASE)
    assert _launch_counts() == before
    assert got.dtype == torch.int32 and got.shape == (Nk // 512,)
    ref, cut_ref = jrk_roll.rk_candidate_bsums(
        jnp.asarray(padded), len(text), h, m, BASE, chunk_bytes=CHUNK,
        interpret=True, words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024)),
        emit="bmask")
    assert cut_ref == cut
    assert np.array_equal(got.numpy(), np.asarray(ref))
    bs = rk_roll.rk_candidate_bsums_plain(words, n_lim, tgt, m, BASE)
    assert torch.equal(got != 0, bs != 0)
    true = _true_groups(padded[:Nk].tobytes(), GATHER_PATS, n_lim)
    g = got.numpy().astype(np.int64)
    assert np.array_equal(g & true, true) and int(np.count_nonzero(true)) >= 10
    assert int(got.max()) < 1 << 16
    assert bin(int(got[20])).count("1") == 1 and bin(int(got[70])).count("1") >= 3


# -- multi_gather='groups' ------------------------------------------------------


def test_extract_region_multi_groups_exact():
    """Every pattern's count and offsets from the group slabs equal the
    oracle's starts <= limit; a small capacity keeps the first ones."""
    text = _planted(GATHER_N, GATHER_PLANTS, 88)
    m = len(GATHER_PATS[0])
    mm = RabinKarpMultiMatcher(GATHER_PATS, PCFG, device="cpu")
    padded = torch.from_numpy(pad_to_multiple(_u8(text), CHUNK).copy())
    Nk, cut = shift_and.kernel_region(padded.numel(), m, CHUNK)
    limit = min(len(text) - m, cut - 1)
    words = padded.view(torch.int32)
    bm = rk_roll.rk_candidate_bmask(words[: Nk // 4], limit,
                                    mm.dev_tables["hashes"], m, BASE)
    x2d = reconstruct.full_words2d(words)
    for cap in (4096, 2):
        out = reconstruct.extract_region_multi_groups(
            bm, x2d, mm.dev_tables["swar_ps"], mm.swar_m, m, limit, cap)
        assert len(out) == len(GATHER_PATS)
        for p, (c, offs, over) in zip(GATHER_PATS, out):
            want = [s for s in find_all(text, p) if s <= limit]
            assert c == len(want) and offs.tolist() == want[:cap]
            assert over == (len(want) > cap) and offs.dtype == torch.int64


@pytest.mark.parametrize("ref", ["interpret", "off"])
def test_groups_match_equals_reference(ref):
    """``match(..., multi_gather='groups')`` equals the JAX
    ``RabinKarpMultiMatcher`` with its Pallas kernels in interpret mode (the
    bmask screen and the group extraction) and with ``use_pallas='off'``,
    and the oracle."""
    text = _planted(GATHER_N, GATHER_PLANTS, 88)
    jcfg = JCFG.replace(multi_gather="groups")
    if ref == "interpret":
        jcfg = jcfg.replace(use_pallas="on", interpret=True)
    js = JaxMulti(GATHER_PATS, jcfg).match(text)
    rs = match(text, GATHER_PATS, algo="rk", config=PCFG.replace(multi_gather="groups"),
               device="cpu")
    for p, r, j in zip(GATHER_PATS, rs, js):
        want = find_all(text, p)
        assert r.algo == "rabin_karp_multi" and not j.overflow and not r.overflow
        assert (r.count, r.offsets_list()) == (j.count, j.offsets_list()) == (
            len(want), want)


class _Spy:
    """Counts calls of a module function it stands in for."""

    def __init__(self, monkeypatch, module, name):
        self.calls, self.fn = 0, getattr(module, name)
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("case", ["m33", "m34", "k40", "width", "overflow"])
def test_groups_edges(case, monkeypatch):
    """m = 33 is the last length on the group route and m = 34 takes
    'blocks' (K5 + extract_region_multi), as in the reference; k = 40 > 31
    runs on groups; past the gather width the block flags take the decode,
    whose plain version runs extract_region_multi (extract_region per
    pattern); on overflow the counts are exact and the offsets the oracle's
    ascending first ``capacity``."""
    groups = _Spy(monkeypatch, reconstruct, "extract_region_multi_groups")
    blocks = _Spy(monkeypatch, reconstruct, "extract_region_multi")
    single = _Spy(monkeypatch, reconstruct, "extract_region")
    m = {"m33": 33, "m34": 34}.get(case, 12)
    k = 40 if case == "k40" else 4
    base = gen_english(TILE + 3333, seed=900 + m + k)
    pats = [base[7919 * i + 5 : 7919 * i + 5 + m] for i in range(k - 1)]
    pats.append(b"\x00" * (m - 1) + b"\xfe")  # absent
    plants = [(SUB * j + 31 - j % 7, pats[j % (k - 1)]) for j in range(1, 60)]
    plants += [(TILE - m // 2, pats[0]), (TILE + 3333 - m, pats[1])]
    text = _planted(TILE + 3333, plants, 900 + m + k)
    cap = 4096
    if case == "width":
        monkeypatch.setattr(reconstruct, "MULTI_BLOCK_TIER", 8)
    if case == "overflow":  # a pattern absent from the corpus, planted densely
        pats[0] = b"#e#the#quik#"
        text = _planted(TILE + 3333, plants + [(TILE // 4 + 40 * i, pats[0])
                                               for i in range(3000)], 901)
        cap = 500
    rs = check_many(text, pats, algo="rabin_karp", jax_ref=case != "k40",
                    pcfg=PCFG.replace(multi_gather="groups", capacity=cap),
                    jcfg=JCFG.replace(multi_gather="groups", capacity=cap))
    assert all(r.algo == "rabin_karp_multi" for r in rs)
    assert sum(r.count for r in rs) >= 40
    assert groups.calls == (case != "m34") and blocks.calls == (case in ("m34", "width"))
    assert single.calls == (k if case in ("width", "m34") else 0)
    if case == "overflow":
        assert rs[0].overflow and rs[0].count == 3000 and len(rs[0].offsets) == cap


# -- bm_variant='cursor' ---------------------------------------------------------


@pytest.mark.parametrize("m,chunk", [(2, 64), (5, 4096), (16, 100), (40, 64)])
def test_cursor_mask_equals_reference(m, chunk):
    """``bm_start_mask_cursor`` on the JAX matcher's tables
    (``tables_from_reference``) equals the JAX function on the same inputs;
    m = 40 > chunk = 64 reads windows across several lanes."""
    pat = bytes(gen_english(m, seed=400 + m))
    n = 20000 + 37 * m
    text = _u8(_planted(n, [(o, pat) for o in (0, 59, 63, 64, 99, 100, 4095,
                                               8000, n - m)], 410 + m))
    jm = JaxBM(pat)
    dev = tables_from_reference(jm.tables, None, "cpu")
    got = bm_ops.bm_start_mask_cursor(torch.from_numpy(text.copy()),
                                      torch.from_numpy(_u8(pat).copy()),
                                      dev["bad_char"], dev["good_suffix"], chunk)
    want = np.asarray(jbm.bm_start_mask_cursor(
        jnp.asarray(text), jnp.asarray(_u8(pat)), jnp.asarray(jm.tables["bad_char"]),
        jnp.asarray(jm.tables["good_suffix"]), chunk))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert np.flatnonzero(want).tolist() == find_all(text.tobytes(), pat)


CURSOR_CASES = {
    "overlap": (b"aaaa", b"aa"),
    "overlap-long": (b"a" * 300, b"aaa"),
    "nul-suffix": (b"xyz" * 30 + b"ab", b"ab\x00\x00"),
    "seams": (bytes(np.zeros(641, np.uint8)[:59]) + b"vwxyz" * 3
              + bytes(577) + b"vwxyz", b"vwxyz"),
    "tile": (None, b"quick brown fox "),
}


@pytest.mark.parametrize("case", list(CURSOR_CASES))
def test_cursor_match_equals_reference(case):
    """``match(..., bm_variant='cursor')`` equals the JAX ``match`` and the
    oracle: overlapping matches, a NUL-suffixed pattern that the zero
    padding would complete, lane seams at ``bm_chunk=64``, and a text past
    one kernel tile (the cursor route runs no kernel)."""
    text, pat = CURSOR_CASES[case]
    if text is None:
        text = _planted(TILE + 777, [(o, pat) for o in (0, 63, 4090, TILE - 8)], 5)
    pcfg = PCFG.replace(bm_variant="cursor", bm_chunk=64)
    before = (swar.screen_cand_bsums.launches, swar.screened_bsums.launches)
    r = match(text, pat, config=pcfg, device="cpu")
    j = jmatch(text, pat, config=JCFG.replace(bm_variant="cursor", bm_chunk=64))
    want = find_all(text, pat)
    assert (r.count, r.offsets_list(), r.overflow) == (j.count, j.offsets_list(),
                                                       False) == (len(want), want, False)
    assert (swar.screen_cand_bsums.launches, swar.screened_bsums.launches) == before


@pytest.mark.parametrize("algo", ["naive", "kmp", "rabin_karp"])
def test_cursor_config_leaves_other_algorithms(algo):
    """Only Boyer-Moore reads ``bm_variant``: the other algorithms under
    'cursor' take their own kernels' plain versions and equal the JAX
    ``match`` and the oracle, for one pattern and for a list."""
    pats = [b"quick brown fox ", b"fox ", b"the "]
    text = _planted(TILE + 777, [(o, pats[0]) for o in (0, 63, 4090, TILE - 8)], 9)
    pcfg = PCFG.replace(bm_variant="cursor", bm_chunk=64)
    jcfg = JCFG.replace(bm_variant="cursor", bm_chunk=64)
    r = match(text, pats[0], algo=algo, config=pcfg, device="cpu")
    j = jmatch(text, pats[0], algo=algo, config=jcfg)
    want = find_all(text, pats[0])
    assert (r.count, r.offsets_list()) == (j.count, j.offsets_list()) == (len(want), want)
    check_many(text, pats, algo=algo, pcfg=pcfg, jcfg=jcfg)


def test_cursor_drain_past_capacity():
    """``drain=True`` under 'cursor' returns every offset past ``capacity``."""
    text = gen_english(200_000, seed=6)
    cfg = MatchConfig(bm_variant="cursor", bm_chunk=512, capacity=256)
    r = match(text, b"e ", config=cfg, device="cpu")
    want = find_all(text, b"e ")
    assert len(want) > 256 and r.overflow and r.count == len(want)
    assert r.offsets_list() == want[:256]
    r = match(text, b"e ", config=cfg, drain=True, device="cpu")
    assert r.offsets_list() == want and not r.overflow
