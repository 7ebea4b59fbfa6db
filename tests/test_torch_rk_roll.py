"""PyTorch port: the arithmetic of the Rabin-Karp warp scan (K5
``rk_roll.rk_candidate_bsums``, K10b ``rk_candidate_nib``, K6
``rk_candidate_pmask`` and K10c ``rk_candidate_bmask``, all
``rk_warp_kernel`` in ``csrc/rk_roll.cu``), stated in numpy, and the plain
K5/K10b/K6/K10c at ragged region lengths.  Tolerance: exact integer
equality.

``warp_scan`` follows the CUDA kernel step for step: lane l's Horner over
bytes [16l, 16l + 16) of a 512-byte block, the five-step affine combine of
the 32 lanes (``__shfl_up_sync``), the carry from block to block over a
warp's span, the two-block ring of prefixes (64 rows of 16, padded to 20
words), the reads of P(s + m) split at the ring row that ``m & 15`` fixes,
and
``H = P(s + m) - B^m * P(s)`` in uint32, the hit bits clamped at n_lim,
and the block epilogues: K6's per-pattern OR over each lane's set bits
with H recomputed from the ring, joined over the lanes, and K10c's ballot
of the lanes with a hit, its pairs ORed and its even bits compacted into
16.  Its hashes must equal the port's ``ops/rabin_karp.rk_window_hashes``
and the JAX package's ``ops/tables.rk_hash`` for every start, its hit
bits, packed as the kernel stores them, the plain K10b, and its K6 and
K10c masks the plain K6 and K10c.  The kernel itself is held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    rabin_karp as rk_ops,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    tables,
)

BLOCK = 512
LANES = 32
ROW_WORDS = 20  # a ring row: 16 prefixes, 4 words of pad
OTHER_BASE = 0x9E3779B1


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _mul(a, b) -> np.ndarray:
    """uint32 product, wrapping (as the card's IMAD)."""
    return _u32((np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) & 0xFFFFFFFF)


def _shfl_up(x: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_up_sync(x, d)``: lane l gets lane l - d's value, lanes
    below d their own."""
    return np.concatenate([x[:d], x[:-d]])


def warp_scan(region: np.ndarray, b0: int, span: int, m: int, base: int,
              targets=(), n_lim: int | None = None):
    """The kernel's walk of one warp over blocks [b0, b0 + span) of
    ``region`` (uint8, whole blocks; bytes past it read 0): (H uint32[span,
    512], the lanes' hit bits uint32[span, 32] for ``targets``, clamped at
    ``n_lim`` when it is given, K6's masks int[span] and K10c's
    int[span])."""
    B = base & 0xFFFFFFFF
    Bm = pow(B, m, 1 << 32)
    n_blocks = region.size // BLOCK
    lane = np.arange(LANES)
    Bt = [pow(B, t, 1 << 32) for t in range(16)]
    Bd = [pow(B, 16 << r, 1 << 32) for r in range(5)]
    ring = np.zeros(64 * ROW_WORDS, np.uint32)
    carry = np.uint32(0)

    def block_bytes(b):
        if b >= n_blocks:
            return np.zeros((LANES, 16), np.uint32)
        return region[b * BLOCK:(b + 1) * BLOCK].reshape(LANES, 16).astype(np.uint32)

    def prefixes(b):
        nonlocal carry
        x = block_bytes(b)
        P = np.zeros((LANES, 16), np.uint32)  # Horner from 0, then + E * B^t
        L = np.zeros(LANES, np.uint32)
        for t in range(16):
            P[:, t] = L
            L = _u32((_mul(L, B).astype(np.uint64) + x[:, t]) & 0xFFFFFFFF)
        S = L.copy()
        S[0] = (int(S[0]) + int(carry) * Bd[0]) & 0xFFFFFFFF
        for r in range(5):
            y = _shfl_up(S, 1 << r)
            S = np.where(lane >= 1 << r,
                         _u32((S.astype(np.uint64) + _mul(y, Bd[r])) & 0xFFFFFFFF), S)
        E = _shfl_up(S, 1)
        E[0] = carry
        carry = S[31]
        for t in range(16):
            P[:, t] = _u32((P[:, t].astype(np.uint64) + _mul(E, Bt[t])) & 0xFFFFFFFF)
        rows = (32 * (b & 1) + lane) * ROW_WORDS
        ring[rows[:, None] + np.arange(16)] = P

    o = m & 15

    def ring_hash(own, q0, t):
        """H of start 16l + t from the ring (the reads of hash_hits)."""
        col = o + t
        row = q0 if col < 16 else (q0 + 1) & 63
        far = ring[row * ROW_WORDS + (col & 15)]
        return _u32((far.astype(np.uint64) - _mul(ring[own * ROW_WORDS + t], Bm))
                    & 0xFFFFFFFF)

    H = np.zeros((span, BLOCK), np.uint32)
    hits = np.zeros((span, LANES), np.uint32)
    pmask = np.zeros(span, np.int64)
    bmask = np.zeros(span, np.int64)
    prefixes(b0)
    for i, b in enumerate(range(b0, b0 + span)):
        prefixes(b + 1)
        own = (b & 1) * 32 + lane
        q0 = (own + (m >> 4)) & 63
        for t in range(16):
            h = ring_hash(own, q0, t)
            H[i, 16 * lane + t] = h
            for tp in targets:
                hits[i] |= (h == tp).astype(np.uint32) << t
        if n_lim is not None and (b + 1) * BLOCK > n_lim:  # starts past n_lim
            room = n_lim - b * BLOCK - 16 * lane + 1
            hits[i] &= np.where(room >= 16, 0xFFFF, np.where(
                room <= 0, 0, (1 << np.clip(room, 0, 15)) - 1)).astype(np.uint32)
        # K10c: the ballot of lanes with a hit, pairs ORed, even bits
        # compacted.
        g = sum(1 << int(x) for x in np.flatnonzero(hits[i]))
        g = (g | g >> 1) & 0x55555555
        for shift, keep in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                            (8, 0x0000FFFF)):
            g = (g | g >> shift) & keep
        bmask[i] = g
        # K6: each lane walks its set bits, H again from the ring, and ORs
        # bit p per target p equal to it; the OR over the lanes.
        for ln in range(LANES):
            h = int(hits[i, ln])
            while h:
                t = (h & -h).bit_length() - 1
                ht = ring_hash(own[ln], q0[ln], t)
                for p, tp in enumerate(targets):
                    pmask[i] |= int(ht == tp) << p
                h &= h - 1
    return H, hits, pmask, bmask


def _text(n_blocks: int, seed: int) -> np.ndarray:
    """Seeded bytes, three in four at or above 0x80."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0x80, 0x100, n_blocks * BLOCK)
    lo = rng.integers(0, 0x80, n_blocks * BLOCK)
    return np.where(rng.random(n_blocks * BLOCK) < 0.75, hi, lo).astype(np.uint8)


@pytest.mark.parametrize("base", [int(tables.RK_BASE), OTHER_BASE], ids=["fnv", "odd"])
@pytest.mark.parametrize("m", [1, 2, 16, 509])
@pytest.mark.parametrize("span", [1, 2, 33])
def test_warp_scan_hashes_equal_direct_sums(span, m, base):
    """Every start's hash from the warp scan, over a span that starts mid-
    text (block 3, odd, so the ring's second slot comes first), equals the
    direct window sum and the JAX package's rk_hash; the region ends one
    block after the span, so the last windows read zeros past it."""
    b0 = 3
    region = _text(b0 + span + 1, seed=span * 1000 + m)
    H, *_ = warp_scan(region, b0, span, m, base)
    starts = np.arange(b0 * BLOCK, (b0 + span) * BLOCK)
    powers = torch.from_numpy(tables.rk_constants(m, base)["powers"].astype(np.int64))
    direct = rk_ops.rk_window_hashes(torch.from_numpy(region), powers).numpy()
    np.testing.assert_array_equal(H.reshape(-1).astype(np.int64), direct[starts])
    padded = np.concatenate([region, np.zeros(m, np.uint8)])
    c = jtables.rk_constants(m, base)
    step = 1 if span < 33 else 7  # 2,400 windows of the 33-block span
    for s in starts[::step]:
        assert H.reshape(-1)[s - b0 * BLOCK] == jtables.rk_hash(padded[s:s + m], c), s


@pytest.mark.parametrize("m", [2, 16, 509])
def test_warp_scan_emits_plain_nib(m):
    """The warp scan's hit bits, clamped at n_lim and packed as the kernel
    stores them (lane l's bits 4w..4w+3 as nibble word 4l + w), equal the
    plain K10b's nibble plane and block sums."""
    n_blocks = 5
    region = _text(n_blocks, seed=77 + m)
    pats = [region[700:700 + m].tobytes(), region[2000:2000 + m].tobytes()]
    base = int(tables.RK_BASE)
    c = tables.rk_constants(m, base)
    tgt = [np.uint32(tables.rk_hash(np.frombuffer(p, np.uint8), c)) for p in pats]
    n_lim = n_blocks * BLOCK - BLOCK + 137
    _, hits, _, _ = warp_scan(region, 0, n_blocks, m, base, tgt, n_lim)
    nib = np.stack([(hits >> (4 * w)) & 0xF for w in range(4)], -1).reshape(-1)
    bs = np.array([sum(bin(int(h)).count("1") for h in row) for row in hits])
    words = torch.from_numpy(region.view(np.int32).copy())
    targets = torch.tensor([int(t) for t in tgt], dtype=torch.int64)
    nib_p, bs_p = rk_roll.rk_candidate_nib(words, n_lim, targets, m, base)
    np.testing.assert_array_equal(nib.astype(np.int32), nib_p.numpy())
    np.testing.assert_array_equal(bs, bs_p.numpy())
    assert bs.sum() >= 2


@pytest.mark.parametrize("k", [2, 31, 40])
@pytest.mark.parametrize("m", [2, 16, 509])
def test_warp_scan_emits_plain_pmask_bmask(m, k):
    """The warp scan's K6 masks (k <= 31) and K10c masks, with the hit bits
    clamped at n_lim mid-way into the last block, equal the plain K6's and
    K10c's bit for bit.  The targets are slices of the warp's span, the
    first two equal (each gets its bit), so the last (bit 30 at k = 31)
    hits too; the span starts at an odd block."""
    n_blocks, b0 = 6, 1
    region = _text(n_blocks, seed=5 * m + k)
    step = (region.size - 2 * BLOCK - m) // k
    pats = [region[BLOCK + 7 + step * i:][:m].tobytes() for i in range(k - 1)]
    pats = [pats[0]] + pats
    base = int(tables.RK_BASE)
    c = tables.rk_constants(m, base)
    tgt = [np.uint32(tables.rk_hash(np.frombuffer(p, np.uint8), c)) for p in pats]
    n_lim = n_blocks * BLOCK - BLOCK + 137
    _, _, pmask, bmask = warp_scan(region, b0, n_blocks - b0, m, base, tgt, n_lim)
    words = torch.from_numpy(region.view(np.int32).copy())
    targets = torch.tensor([int(t) for t in tgt], dtype=torch.int64)
    bm_p = rk_roll.rk_candidate_bmask_plain(words, n_lim, targets, m, base).numpy()
    np.testing.assert_array_equal(bmask, bm_p[b0:])
    assert bmask.any()
    if k <= rk_roll.MAX_PMASK_PATTERNS:
        pm_p = rk_roll.rk_candidate_pmask_plain(words, n_lim, targets, m, base).numpy()
        np.testing.assert_array_equal(pmask, pm_p[b0:])
        np.testing.assert_array_equal(pmask & 1, pmask >> 1 & 1)  # equal targets
        assert (pmask >> (k - 1) & 1).any() and len(set(pats)) == k - 1
        np.testing.assert_array_equal(pmask != 0, bmask != 0)


RAGGED_PATTERNS = [b"quick brown fox ", b"\xe4\xb8\x80\xc3\xa9 x",
                   bytes(range(1, 256)) + bytes(range(1, 255))]  # m = 509


def _ragged_region(blocks: int, pat: bytes) -> bytes:
    """``blocks`` 512-byte blocks of seeded high bytes, whole copies of
    ``pat`` planted (the last ending in the last block) and its first two
    bytes as the region's last two."""
    n = BLOCK * blocks
    data = bytearray(_text(blocks, seed=blocks + len(pat)).tobytes())
    m = len(pat)
    end = 0
    for off in (0, n // 2 - 3, n - BLOCK - m // 2, n - 300, n - m - 7):
        if off >= end and off + m <= n:
            data[off:off + m] = pat
            end = off + m
    data[n - 2:] = pat[:2]
    return bytes(data)


@pytest.mark.parametrize("pat", RAGGED_PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("blocks", [1, 31, 32, 33, 97])
def test_plain_rk_scans_on_ragged_regions(blocks, pat):
    """At the ragged lengths of the tiled scans, n_lim mid-way into the last
    block and at its last byte: the plain K10b's plane holds every true
    start <= n_lim, its bs is the plane's per-block popcount, and the plain
    K5 equals that bs; the plain K6's mask holds every true start's block
    and the plain K10c's every true start's 32-byte group, each nonzero
    exactly where K5 is."""
    data = _ragged_region(blocks, pat)
    m = len(pat)
    words = torch.from_numpy(np.frombuffer(data, np.int32).copy())
    base = int(tables.RK_BASE)
    targets = torch.tensor([int(tables.rk_hash(np.frombuffer(pat, np.uint8),
                                               tables.rk_constants(m, base)))])
    true = find_all(data, pat)
    n = len(data)
    for n_lim in (n - BLOCK + 137, n - 1):
        nib, bs = rk_roll.rk_candidate_nib(words, n_lim, targets, m, base)
        bits = ((nib[:, None] >> torch.arange(4)) & 1).reshape(-1).bool()
        want = [s for s in true if s <= n_lim]
        assert want and all(bits[s] for s in want), n_lim
        assert not bits[n_lim + 1:].any()
        assert torch.equal(bs, bits.view(-1, BLOCK).sum(1, dtype=torch.int32))
        assert torch.equal(rk_roll.rk_candidate_bsums(words, n_lim, targets, m, base), bs)
        pm = rk_roll.rk_candidate_pmask(words, n_lim, targets, m, base)
        bm = rk_roll.rk_candidate_bmask(words, n_lim, targets, m, base)
        for s in want:
            assert pm[s // BLOCK] == 1, (n_lim, s)
            assert bm[s // BLOCK] >> (s % BLOCK // rk_roll.GROUP_BYTES) & 1, (n_lim, s)
        assert torch.equal(pm != 0, bs != 0) and torch.equal(bm != 0, bs != 0)
