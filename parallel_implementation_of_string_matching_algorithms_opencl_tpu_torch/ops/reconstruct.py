"""Block sums to (count, offsets, overflow) over the kernel region
(counterpart of the JAX ``ops/reconstruct.py``: ``full_words2d``,
``_verify_chunks``, ``extract_region``).

A scan kernel's block sums mark which 512-byte blocks may hold matches:
exact counts from the naive verify, a candidate superset from the
Boyer-Moore probe screen.  The 4 KiB chunks holding candidates are gathered
from the ``(N/4096, 1024)`` word view and verified by the same word
compares as the kernels, so every branch recounts exactly.  When the
candidate chunks outnumber the gather width, one full rescan by the naive
kernel (K2, ``swar.naive_nib``) replaces the gather.

Offsets are always the true ascending first ``capacity`` matches: the
reference's tier switch, T-slot extraction and give-up path are TPU
machinery with no counterpart here.
"""

from __future__ import annotations

import torch

from ..kernels import swar
from . import extract

# Gather width in 4 KiB chunks, by text size class (the reference's
# selector constants, same names and values): a region with more candidate
# chunks than this takes the K2 rescan in both packages.
SPARSE_CHUNKS = 8192
SPARSE_CHUNKS_SMALL = 4096
SMALL_TEXT_CHUNKS = 65536  # <= 256 MiB


def full_words2d(words: torch.Tensor) -> torch.Tensor:
    """(R, 1024) int32 chunk-row view of the padded text's words (the text
    length is a multiple of 4096 bytes)."""
    return words.view(-1, 1024)


def _verify_chunks(x2d, gids, P, M, Mnp, limit: int) -> torch.Tensor:
    """int32[G, 1024] nibble plane: bit a of word w of gathered chunk g =
    exact match starting at byte gids[g]*4096 + 4w + a, clamped to
    ``limit``.  A chunk's matches may read into the next chunk's first nw
    words."""
    R = x2d.shape[0]
    nw = P.shape[1]
    nxt = (gids + 1).clamp(max=R - 1)
    win = torch.cat([x2d[gids], x2d[nxt, :nw]], dim=1)
    nib = torch.zeros((gids.shape[0], 1024), dtype=torch.int32,
                      device=x2d.device)
    for a in range(4):
        acc = None
        for k in range(nw):
            if Mnp[a, k] == 0:
                continue  # the pattern does not touch this word
            w = win[:, k : k + 1024]
            eq = (w == P[a, k]) if Mnp[a, k] == -1 else (
                (w & M[a, k]) == P[a, k]
            )
            acc = eq if acc is None else acc & eq
        nib |= acc.to(torch.int32) << a
    word_pos = gids[:, None] * 4096 + 4 * torch.arange(
        1024, dtype=torch.int64, device=x2d.device
    )[None, :]
    keep = (limit - word_pos + 1).clamp(0, 4)
    return nib & ((1 << keep) - 1).to(torch.int32)


def extract_region(bs, x2d, P, M, m: int, limit: int, capacity: int):
    """(count, offsets, overflow) for the kernel region.

    ``bs``: int32[NB] per-512-byte-block counts from a scan kernel (exact,
    or a candidate superset), clamped in-kernel.  ``x2d``: the (R, 1024)
    word view of the whole padded text (``full_words2d``).  ``limit``: the
    largest valid start, min(n-m, cut-1).  The count is exact; offsets are
    the ascending first ``capacity`` matches."""
    Mnp = swar.mask_words(m)
    Lr = bs.shape[0] // 8
    chunkc = bs.view(Lr, 8).sum(1)
    cap_g = min(
        SPARSE_CHUNKS_SMALL if Lr <= SMALL_TEXT_CHUNKS else SPARSE_CHUNKS,
        Lr,
    )
    gids = extract.sorted_nonzero_ids(chunkc)
    if gids.numel() > cap_g:
        return _dense(bs.shape[0], x2d, P, M, limit, capacity)
    nib = _verify_chunks(x2d, gids, P, M, Mnp, limit)
    pos = extract.nib_positions(nib, gids * 4096)
    count = pos.numel()
    return count, pos[:capacity], count > capacity


def _dense(nb: int, x2d, P, M, limit: int, capacity: int):
    """Full naive rescan of the region's ``nb`` blocks (K2): exact verify
    of every position, then decode only the blocks that hold one of the
    first ``capacity`` matches."""
    nib, bs2 = swar.naive_nib(x2d.view(-1)[: nb * 128], limit, P, M)
    count = int(bs2.sum())
    before = torch.cumsum(bs2, 0) - bs2
    blocks = extract.sorted_nonzero_ids((bs2 > 0) & (before < capacity))
    pos = extract.nib_positions(nib.view(-1, 128)[blocks], blocks * 512)
    return count, pos[:capacity], count > capacity
