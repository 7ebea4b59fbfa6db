"""PyTorch port: the arithmetic of the Shift-AND warp scan (K4
``shift_and.kmp_bsums`` and K10a ``shift_and.kmp_nib``, and K9, the same
wrappers on the composed-4 step or the compare-B lookup: all
``kmp_warp_kernel`` in ``csrc/shift_and.cu``), stated in numpy, against
the plain K4/K10a and the JAX package's Pallas kernel.  Tolerance: exact
integer equality.

``warp_scan`` follows the CUDA kernel step for step: the B table aligned to
the top of the K state words (shifted up by o = 32K - m, ones below o),
the cold state at the span's first byte, each lane's 16-step map from all
ones with its hit bits h (step t at bit 16 - t), lane 0 folding in the
state carried from the previous block, the inclusive ``__shfl_up_sync``
scan of maps (X, then Y over 16d bytes) -> (X << 16d | ones) & Y over K
words that stops once it reaches m - 1 bytes back, the hits as h & (D_in's
top word >> 15) bit-reversed into byte order, lane 31's state as the next
carry, the end-to-start shift that reads lanes l + a and l + a + 1 of this
block and the next (a = (m-1) >> 4, then down by r = (m-1) & 15), the
n_lim clamp, the nibble packing and the block sums; ``kmp_warp`` runs every
warp of a grid over its span, as the persistent grid does.  K9's pieces:
``lane_maps_composed``, the lane map built four bytes a step with its hits
taken from fixed bits of the aligned table, and ``compare_table``, the row
compare-B's prologue builds from ``shift_and.compare_tables``.  The kernel
itself is held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py), and the plain versions against
the Pallas kernel in tests/test_torch_scan_kernels.py and
tests/test_torch_nib.py.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    shift_and as jshift_and,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    emit as jemit,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    shift_and,
)

BLOCK = 512
LANES = 32
ONES = np.uint64(0xFFFFFFFF)
KMP_M = [1, 2, 5, 16, 17, 31, 32, 33, 64, 255, 256]


def _u32(x) -> np.ndarray:
    """Low 32 bits, kept as uint64 so that shifts do not wrap early."""
    return np.asarray(x, np.uint64) & ONES


def _shl(x, s: int) -> np.ndarray:
    return _u32(np.asarray(x, np.uint64) << np.uint64(s))


def _shr(x, s: int) -> np.ndarray:
    return np.asarray(x, np.uint64) >> np.uint64(s)


def top_table(bt: np.ndarray, m: int) -> np.ndarray:
    """uint32[K, 256] as the kernel loads it into shared memory: ``b_table``
    shifted up by o = 32K - m bits across the K words, ones in bits
    0..o-1, so that bit 31 of word K-1 is pattern byte m-1's."""
    B = np.asarray(bt).view(np.uint32).astype(np.uint64)
    o = 32 * B.shape[0] - m
    if o == 0:
        return B.copy()
    out = np.empty_like(B)
    for k in range(B.shape[0]):
        low = _shr(B[k - 1], 32 - o) if k else np.uint64((1 << o) - 1)
        out[k] = _shl(B[k], o) | low
    return out


def shl_fill(x: np.ndarray, n: int) -> np.ndarray:
    """x << n over the K words of the last axis, ones shifted in."""
    K = x.shape[-1]
    q, s = n // 32, n % 32
    out = np.empty_like(x)
    for k in range(K):
        if k < q:
            out[..., k] = ONES
        elif s == 0:
            out[..., k] = x[..., k - q]
        elif k == q:
            out[..., k] = _shl(x[..., 0], s) | np.uint64((1 << s) - 1)
        else:
            out[..., k] = _shl(x[..., k - q], s) | _shr(x[..., k - q - 1], 32 - s)
    return out


def _shfl_up(x: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_up_sync(x, d)``: lane l gets lane l - d's value, lanes
    below d their own."""
    return np.concatenate([x[:d], x[:-d]])


def _brev16(x: np.ndarray) -> np.ndarray:
    """``__brev(x) >> 16`` of 16-bit values."""
    out = np.zeros_like(x)
    for i in range(16):
        out |= (_shr(x, i) & np.uint64(1)) << np.uint64(15 - i)
    return out


def _step(D: np.ndarray, Bt: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One automaton step of every lane's K-word state D on its byte c:
    D = ((D << 1) | 1) & B[c], bit 31 of word k-1 carried into word k."""
    out = np.empty_like(D)
    cin = np.ones(len(D), np.uint64)
    for k in range(D.shape[1]):
        out[:, k] = (_shl(D[:, k], 1) | cin) & Bt[k, c]
        cin = _shr(D[:, k], 31)
    return out


def lane_maps(Bt: np.ndarray, x: np.ndarray):
    """Each lane's map over its 16 bytes ``x`` (uint8[32, 16]): the state M
    (uint64[32, K]) after the per-byte step from all ones, and h, the hit
    bit (bit 31 of word K-1) after step t at bit 16 - t."""
    M = np.full((LANES, Bt.shape[0]), ONES)
    h = np.zeros(LANES, np.uint64)
    for i in range(16):
        M = _step(M, Bt, x[:, i])
        h = _shl(h, 1) | _shr(M[:, -1], 31)
    return M, h


def lane_maps_composed(Bt: np.ndarray, x: np.ndarray):
    """``lane_maps`` on the composed-4 step: four bytes c0..c3 a step, M =
    (M << 4 | 15) & (B[c0] << 3 | 7) & (B[c1] << 2 | 3) & (B[c2] << 1 | 1)
    & B[c3] over the K words; the hits after bytes 0..3 of the four in bits
    31..28 of (M's top word << 1) & B[c0] & (B[c1] >> 1 | bit 31) & (B[c2]
    >> 2 | bits 30-31) & (B[c3] >> 3 | bits 29-31) (top words), moved into
    h four at a time."""
    M = np.full((LANES, Bt.shape[0]), ONES)
    h = np.zeros(LANES, np.uint64)
    for w in range(4):
        g = [Bt[:, x[:, 4 * w + b]].T for b in range(4)]  # uint64[32, K] each
        H = (_shl_fill_bits(g[0], 3) & _shl_fill_bits(g[1], 2)
             & _shl_fill_bits(g[2], 1) & g[3])
        top = M[:, -1]
        M = _shl_fill_bits(M, 4) & H
        hits = _shl(top, 1) & g[0][:, -1]
        for b in (1, 2, 3):  # ones shifted in: byte b is not yet reached
            hits &= _shr(g[b][:, -1], b) | _shl(ONES, 32 - b)
        h = _shl(h, 4) | _shr(hits, 28)
    return M, h


def compare_table(pat_key: bytes, m: int) -> np.ndarray:
    """uint32[1, 256] as compare-B's CTA prologue builds it: word c is the
    mask of the distinct byte equal to c (``shift_and.compare_tables``), 0
    if none is, shifted to the top as ``top_table``."""
    byte, mask = (a.view(np.uint32) for a in shift_and.compare_tables(pat_key))
    B = np.zeros((1, 256), np.uint32)
    for c in range(256):
        for d, mk in zip(byte, mask):
            B[0, c] |= mk if d == c else 0
    return top_table(B.view(np.int32), m)


def warp_scan(region: np.ndarray, Bt: np.ndarray, m: int, b0: int, b_end: int,
              n_lim: int, bs: np.ndarray, nib: np.ndarray, maps=lane_maps) -> None:
    """One warp's walk over blocks [b0, b_end) of ``region`` (uint8, whole
    blocks; bytes past it read 0) with the lane maps ``maps``: writes bs[b]
    and nibble words nib[128b .. 128b + 127] as the kernel stores them."""
    K = Bt.shape[0]
    n_blocks = region.size // BLOCK
    lane = np.arange(LANES)
    carry = np.zeros(K, np.uint64)
    carry[0] = (1 << (32 * K - m)) - 1  # cold: no pattern prefix

    def ends(b):
        """Lane l's end bits of block b (bit i: a match ends at byte
        16l + i); moves the carry on to block b + 1."""
        nonlocal carry
        x = (region[b * BLOCK:(b + 1) * BLOCK] if b < n_blocks
             else np.zeros(BLOCK, np.uint8)).reshape(LANES, 16)
        M, h = maps(Bt, x)
        S = M.copy()
        S[0] = shl_fill(carry, 16) & M[0]
        for r in range(5):
            if (16 << r) >= m - 1:
                break
            d = 1 << r
            S = np.where((lane >= d)[:, None], shl_fill(_shfl_up(S, d), 16 * d) & S, S)
        top = _shfl_up(S[:, K - 1], 1)
        top[0] = carry[K - 1]
        carry = S[31].copy()
        return _brev16(h & _shr(top, 15))

    a, r = (m - 1) >> 4, (m - 1) & 15
    j = lane + a
    prev = ends(b0)
    for b in range(b0, b_end):
        cur = ends(b + 1)
        pair = prev | _shl(cur, 16)
        lo = np.where(j < 32, pair[j & 31] & np.uint64(0xFFFF), _shr(pair[j & 31], 16))
        hi = np.where(j + 1 < 32, pair[(j + 1) & 31] & np.uint64(0xFFFF),
                      _shr(pair[(j + 1) & 31], 16))
        st = _shr(lo | _shl(hi, 16), r) & np.uint64(0xFFFF)  # bit t: start 16l + t
        prev = cur
        room = n_lim - b * BLOCK - 16 * lane + 1
        st &= np.where(room >= 16, 0xFFFF, (1 << np.clip(room, 0, 16)) - 1).astype(np.uint64)
        bs[b] = sum(bin(int(s)).count("1") for s in st)
        for w in range(4):
            nib[b * 128 + 4 * lane + w] = _shr(st, 4 * w) & np.uint64(0xF)


def kmp_warp(region: np.ndarray, bt: np.ndarray, m: int, n_lim: int, n_warps: int,
             maps=lane_maps, Bt: np.ndarray | None = None):
    """(bs, nib) of every warp of a grid of ``n_warps`` over ``region``,
    each on its contiguous span of ceil(blocks / n_warps) blocks, on the
    lane maps ``maps`` and the aligned table ``Bt`` (default: ``bt``'s)."""
    n_blocks = region.size // BLOCK
    Bt = top_table(bt, m) if Bt is None else Bt
    span = -(-n_blocks // n_warps)
    bs = np.zeros(n_blocks, np.int64)
    nib = np.zeros(n_blocks * 128, np.int64)
    for w in range(n_warps):
        b0 = w * span
        if b0 < n_blocks:
            warp_scan(region, Bt, m, b0, min(b0 + span, n_blocks), n_lim, bs, nib,
                      maps)
    return bs, nib


def _patterns(m: int) -> list[bytes]:
    """m a's with a 'b' a third of the way in (m >= 2) and, for m >= 2,
    the same ending in NUL bytes (two, one at m = 2)."""
    pat = bytearray(b"a" * m)
    if m >= 2:
        pat[m // 3] = ord("b")
    if m == 1:
        return [bytes(pat)]
    z = 1 if m == 2 else 2
    return [bytes(pat), bytes(pat[: m - z]) + b"\x00" * z]


def _region(n_blocks: int, pat: bytes, seed: int) -> np.ndarray:
    """Seeded text of ``n_blocks`` blocks, nine bytes in ten 'a', so that
    the pattern's suffixes occur often without its prefix; ``pat`` planted
    across every other block boundary (so across span boundaries) and, at
    the others, ``pat`` with one byte changed (a near miss); the region
    ends in ``pat`` without its trailing NUL bytes."""
    rng = np.random.default_rng(seed)
    n = n_blocks * BLOCK
    data = np.where(rng.random(n) < 0.9, ord("a"), ord("b")).astype(np.uint8)
    m = len(pat)
    end = 0
    for b in range(1, n_blocks):
        off = BLOCK * b - m // 2 - b % 3
        if off >= end and off + m <= n:
            data[off:off + m] = np.frombuffer(pat, np.uint8)
            if b % 2:
                data[off + (7 * b) % m] ^= 3
            end = off + m
    head = pat.rstrip(b"\x00")
    data[n - len(head):] = np.frombuffer(head, np.uint8)
    return data


# (blocks, warps) giving spans of 1 (some warps idle), 2 (the last warp's
# span shorter) and 33 blocks (the last warp's 4).
SPANS = {1: (5, 8), 2: (7, 4), 33: (70, 3)}


@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("m", KMP_M)
def test_warp_scan_equals_plain(m, span):
    """The warp scan over a grid of spans, with n_lim mid-way into the last
    block and at its last byte, equals the plain K4's block sums and K10a's
    nibble plane for a pattern and the same ending in NUL bytes, which
    matches at the region's end against the zeros past it."""
    n_blocks, n_warps = SPANS[span]
    for pat in _patterns(m):
        region = _region(n_blocks, pat, seed=100 * m + span)
        bt = shift_and.b_table(np.frombuffer(pat, np.uint8))
        words = torch.from_numpy(region.view(np.int32).copy())
        n = region.size
        for n_lim in (n - BLOCK + 137, n - 1):
            bs, nib = kmp_warp(region, bt, m, n_lim, n_warps)
            nib_p, bs_p = shift_and.kmp_nib_plain(words, n_lim, torch.from_numpy(bt), m)
            assert np.array_equal(bs, bs_p.numpy()), (pat, n_lim)
            assert np.array_equal(nib, nib_p.numpy()), (pat, n_lim)
            assert np.array_equal(bs_p.numpy(), shift_and.kmp_bsums_plain(
                words, n_lim, torch.from_numpy(bt), m).numpy())
        assert bs.sum() >= n_blocks // 2
        if pat.endswith(b"\x00"):
            s = n - len(pat.rstrip(b"\x00"))
            assert nib[s // 4] >> (s % 4) & 1


def _shl_fill_bits(x: np.ndarray, t: int) -> np.ndarray:
    """x << t | (2^t - 1) over the K words of the last axis, for t < 32."""
    out = np.empty_like(x)
    for k in range(x.shape[-1]):
        low = _shr(x[..., k - 1], 32 - t) if k else np.uint64((1 << t) - 1)
        out[..., k] = _shl(x[..., k], t) | low
    return out


@pytest.mark.parametrize("m", [5, 33, 256])
def test_lane_map_composes_with_any_entering_state(m):
    """The lemma the lane maps rest on: from any state D entering a lane
    (bits below o all ones, as every state of the aligned automaton has),
    t steps give (D << t | (2^t - 1)) & M_t, M_t the state after t steps
    from all ones; so the hit after step t is bit 31 - t of D's top word
    AND h's bit 16 - t."""
    rng = np.random.default_rng(m)
    pat = rng.choice(np.frombuffer(b"ab", np.uint8), m)
    Bt = top_table(shift_and.b_table(pat), m)
    K = Bt.shape[0]
    x = rng.choice(np.frombuffer(b"ab", np.uint8), (LANES, 16))
    D = rng.integers(0, 1 << 32, (LANES, K), dtype=np.uint64)
    D[:, 0] |= np.uint64((1 << (32 * K - m)) - 1)
    state, Mt = D.copy(), np.full((LANES, K), ONES)
    hits = np.zeros(LANES, np.uint64)
    for t in range(1, 17):
        state, Mt = _step(state, Bt, x[:, t - 1]), _step(Mt, Bt, x[:, t - 1])
        hits |= _shr(state[:, -1], 31) << np.uint64(16 - t)
        assert np.array_equal(state, _shl_fill_bits(D, t) & Mt), t
    M, h = lane_maps(Bt, x)
    assert np.array_equal(Mt, M)
    assert np.array_equal(shl_fill(D, 16), _shl_fill_bits(D, 16))
    assert np.array_equal(hits, h & _shr(D[:, -1], 15))
    assert hits.any() and (h & ~hits).any()


@pytest.fixture
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


@pytest.mark.usefixtures("_small_kernel_floor")
def test_warp_scan_equals_pallas():
    """On one 512 KiB tile of English (K = 1, m = 16, the pattern across
    the reference's 512-byte sub-chunks and at the last valid start), the
    warp scan over 24 spans equals the Pallas ``kmp_bsums`` and, after the
    reference's downstream ``nibble_valid``, its ``kmp_nib``, run in
    interpret mode."""
    chunk = 4096
    pat = b"quick brown fox "
    m = len(pat)
    n = 128 * chunk - 1
    data = bytearray(gen_english(n, seed=12))
    for off in range(0, n - m, 7919):
        data[off:off + m] = pat
    data[n - m:] = pat
    padded = pad_to_multiple(np.frombuffer(bytes(data), np.uint8), 128 * chunk)
    Nk, cut = shift_and.kernel_region(len(padded), m, chunk)
    region = padded[:Nk]
    limit = min(n - m, cut - 1)
    u = np.frombuffer(pat, np.uint8)
    bs, nib = kmp_warp(region, shift_and.b_table(u), m, limit, n_warps=24)
    kw = dict(chunk_bytes=chunk, interpret=True,
              words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024)))
    bt = jnp.asarray(jshift_and.b_table(u))
    bs_ref, _ = jshift_and.kmp_bsums(jnp.asarray(padded), n, bt, m, **kw)
    nib_ref, _ = jshift_and.kmp_nib(jnp.asarray(padded), n, bt, m, **kw)
    assert np.array_equal(bs, np.asarray(bs_ref))
    assert np.array_equal(nib, np.asarray(jemit.nibble_valid(nib_ref, limit)))
    assert bs.sum() == region[: limit + m].tobytes().count(pat) > 60


# -- K9: the composed-4 step and the compare-B lookup -------------------------

def _lane_region(n_blocks: int, pat: bytes, seed: int) -> np.ndarray:
    """``_region``'s text with the pattern also across a 16-byte lane
    boundary inside blocks (a different lane each block, where it fits
    between ``_region``'s plants), one byte changed in every third (a near
    miss); the region still ends in ``pat`` without its trailing NUL
    bytes."""
    data = _region(n_blocks, pat, seed)
    m = len(pat)
    for b in range(n_blocks - 1):
        lo = BLOCK * b - m // 2 - b % 3 + m  # past block b's plant
        hi = BLOCK * (b + 1) - m // 2 - (b + 1) % 3  # before block b + 1's
        for t in range(32):
            off = BLOCK * b + 16 * ((7 * b + t) % 32) - m // 3
            if max(lo, 0) <= off and off + m <= hi:
                data[off:off + m] = np.frombuffer(pat, np.uint8)
                if b % 3 == 0:
                    data[off + (5 * b) % m] ^= 1
                break
    return data


def _k9_tables(pat: bytes, m: int, variant: str):
    """(lane maps, aligned table) of a K9 variant: 'composed' (the table),
    'compare_b' (per byte) or 'both' (composed on compare-B's table)."""
    maps = lane_maps if variant == "compare_b" else lane_maps_composed
    bt = shift_and.b_table(np.frombuffer(pat, np.uint8))
    Bt = top_table(bt, m)
    if variant != "composed":
        Bt_cmp = compare_table(pat, m)
        assert np.array_equal(Bt_cmp, Bt)
        Bt = Bt_cmp
    return maps, bt, Bt


K9_MODEL_CASES = ([(m, v) for m in (5, 16, 17, 31, 32) for v in ("compare_b", "both")]
                  + [(m, "composed") for m in (5, 33, 64, 256)])


@pytest.mark.parametrize("m,variant", K9_MODEL_CASES,
                         ids=[f"m{m}-{v}" for m, v in K9_MODEL_CASES])
def test_k9_warp_scan_equals_plain(m, variant):
    """K9 in the warp scan (the composed lane maps, compare-B's table, or
    both) over one warp's span and over several, with the pattern and near
    misses across block and lane boundaries and n_lim mid-way into the last
    block and at its last byte, equals the plain K4's block sums and K10a's
    nibble plane."""
    for span in (2, 33):
        n_blocks, n_warps = SPANS[span]
        for pat in _patterns(m):
            maps, bt, Bt = _k9_tables(pat, m, variant)
            region = _lane_region(n_blocks, pat, seed=100 * m + span + 7)
            words = torch.from_numpy(region.view(np.int32).copy())
            n = region.size
            for n_lim in (n - BLOCK + 137, n - 1):
                bs, nib = kmp_warp(region, bt, m, n_lim, n_warps, maps=maps, Bt=Bt)
                nib_p, bs_p = shift_and.kmp_nib_plain(words, n_lim, torch.from_numpy(bt), m)
                assert np.array_equal(bs, bs_p.numpy()), (pat, span, n_lim)
                assert np.array_equal(nib, nib_p.numpy()), (pat, span, n_lim)
            assert bs.sum() >= n_blocks // 2


def test_composed_lane_map_equals_per_byte():
    """On random lanes' bytes the composed lane map (four bytes a step,
    hits from fixed bits) gives the per-byte map and its hits, at every K
    and at the shortest composed m."""
    rng = np.random.default_rng(13)
    for m in (5, 16, 32, 33, 64, 100, 256):
        pat = rng.choice(np.frombuffer(b"ab", np.uint8), m)
        Bt = top_table(shift_and.b_table(pat), m)
        for _ in range(3):
            x = rng.choice(np.frombuffer(b"aab", np.uint8), (LANES, 16))
            x[rng.integers(0, LANES, 4), rng.integers(0, 16, 4)] = ord("c")
            M, h = lane_maps(Bt, x)
            Mc, hc = lane_maps_composed(Bt, x)
            assert np.array_equal(Mc, M) and np.array_equal(hc, h), m


def _reversed_nibbles(Bt, x):
    """A planted fault: the composed step's four hits moved into h in the
    reverse order."""
    M, h = lane_maps_composed(Bt, x)
    out = np.zeros_like(h)
    for i in range(16):
        out |= ((h >> np.uint64(i)) & np.uint64(1)) << np.uint64((i & ~3) | (3 - (i & 3)))
    return M, out


def _no_carry(x: np.ndarray, t: int) -> np.ndarray:
    """A planted fault in the composed step's multiword shifts: word k
    does not take word k-1's top bits."""
    out = _shl(x, t)
    out[..., 0] |= np.uint64((1 << t) - 1)
    return out


@pytest.mark.parametrize("fault,ms", [("nibble order", (5, 16, 33)),
                                      ("carry", (33, 64, 256))])
def test_k9_cases_catch_a_planted_fault(fault, ms, monkeypatch):
    """The composed cases of ``test_k9_warp_scan_equals_plain`` see a
    wrong nibble order and a composed step that drops the carry into word k
    (K >= 2) at every m listed.  (At m = 256 this text's lanes have whole
    nibbles of hit bits, which the reversed order leaves as they were.)"""
    maps = lane_maps_composed
    if fault == "carry":
        monkeypatch.setitem(globals(), "_shl_fill_bits", _no_carry)
    else:
        maps = _reversed_nibbles
    for m in ms:
        n_blocks, n_warps = SPANS[2]
        pat = _patterns(m)[0]
        region = _lane_region(n_blocks, pat, seed=100 * m + 9)
        words = torch.from_numpy(region.view(np.int32).copy())
        bt = shift_and.b_table(np.frombuffer(pat, np.uint8))
        _, nib = kmp_warp(region, bt, m, region.size - 1, n_warps, maps=maps)
        nib_p, bs_p = shift_and.kmp_nib_plain(words, region.size - 1, torch.from_numpy(bt), m)
        assert int(bs_p.sum()) >= n_blocks // 2
        assert not np.array_equal(nib, nib_p.numpy()), (fault, m)


@pytest.mark.usefixtures("_small_kernel_floor")
def test_k9_warp_scan_equals_pallas(monkeypatch):
    """On one 512 KiB tile of English (K = 1, m = 16, the pattern across
    the reference's sub-chunks and at the last valid start), the warp scan
    on the composed lane maps and compare-B's table equals the Pallas
    ``kmp_nib`` with the reference's ``STEP_PATH = "composed"`` and
    ``pat_key``, run in interpret mode, after its downstream
    ``nibble_valid``, and its block sums those nibbles' popcounts."""
    chunk = 4096
    pat = b"quick brown fox "
    m = len(pat)
    n = 128 * chunk - 1
    data = bytearray(gen_english(n, seed=14))
    for off in range(0, n - m, 6007):
        data[off:off + m] = pat
    data[n - m:] = pat
    padded = pad_to_multiple(np.frombuffer(bytes(data), np.uint8), 128 * chunk)
    Nk, cut = shift_and.kernel_region(len(padded), m, chunk)
    region = padded[:Nk]
    limit = min(n - m, cut - 1)
    maps, bt, Bt = _k9_tables(pat, m, "both")
    bs, nib = kmp_warp(region, bt, m, limit, n_warps=24, maps=maps, Bt=Bt)
    monkeypatch.setattr(jshift_and, "STEP_PATH", "composed")
    kw = dict(chunk_bytes=chunk, interpret=True,
              words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024)))
    nib_ref, _ = jshift_and.kmp_nib(jnp.asarray(padded), n, jnp.asarray(jshift_and.b_table(
        np.frombuffer(pat, np.uint8))), m, pat_key=pat, **kw)
    want = np.asarray(jemit.nibble_valid(nib_ref, limit)).astype(np.int64)
    assert np.array_equal(nib, want)
    pop = sum((want >> a) & 1 for a in range(4))
    assert np.array_equal(bs, pop.reshape(-1, 128).sum(1))
    assert bs.sum() == region[: limit + m].tobytes().count(pat) > 80
