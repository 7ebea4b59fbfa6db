"""Block sums to (count, offsets, overflow) over the kernel region
(counterpart of the JAX ``ops/reconstruct.py``: ``full_words2d``,
``_verify_chunks``, ``extract_region``, and the multi-pattern
``extract_region_multi_pselect`` / ``extract_region_multi`` /
``extract_region_multi_groups``).

A scan kernel's block sums mark which 512-byte blocks may hold matches:
exact counts from the naive verify (and the KMP automaton for m <= 32), a
candidate superset from the Boyer-Moore probe screen, the Rabin-Karp hash
screen and the KMP ``pattern[:32]`` screen.  The 4 KiB chunks holding candidates are gathered
from the ``(N/4096, 1024)`` word view and verified by the same word
compares as the kernels, so every branch recounts exactly.  When the
candidate chunks outnumber the gather width, one full rescan by the naive
kernel (K2, ``swar.naive_nib``) replaces the gather.

On the card the chain gives way to one decode: ``extract_blocks`` hands
the scan's block flags to ``swar.decode_blocks``, a CUDA kernel that
verifies the flagged blocks where they lie and the tail the scan did not
cover, for every pattern, and reads the counts back once.  The chain below
is its plain version on the CPU (``swar.decode_blocks_plain``), and the
group extraction keeps its own gather on both.

Offsets are always the true ascending first ``capacity`` matches: the
reference's tier switch, T-slot extraction and give-up path are TPU
machinery with no counterpart here.  Several patterns are extracted one
after another, each exact on its own with its own ``capacity``: the
reference's shared union gather, its two-pattern side plane and its
fallback from pattern masks to block sums have no counterpart either; nor
do the group extraction's side plane, T-slot keys, tier ladder and give-up
path.
"""

from __future__ import annotations

import torch

from ..kernels import swar
from ..utils.profiling import span
from . import emit, extract

# Gather width in 4 KiB chunks, by text size class (the reference's
# selector constants, same names and values): a region with more candidate
# chunks than this takes the K2 rescan in both packages.
SPARSE_CHUNKS = 8192
SPARSE_CHUNKS_SMALL = 4096
SMALL_TEXT_CHUNKS = 65536  # <= 256 MiB
# Gather width of the group extraction in occupied 32-byte groups: the
# reference's largest multi-pattern gather tier, MULTI_BLOCK_TIERS[-1].
# More occupied groups than this take extract_region on the block flags.
MULTI_BLOCK_TIER = 524288
GROUP_WORDS = 8  # 32 bytes, 16 groups per 512-byte block


def full_words2d(words: torch.Tensor) -> torch.Tensor:
    """(R, 1024) int32 chunk-row view of the padded text's words (the text
    length is a multiple of 4096 bytes)."""
    return words.view(-1, 1024)


def _verify_words(win, word_pos, P, M, Mnp, limit: int) -> torch.Tensor:
    """int32[R, W] nibble plane: bit a of word w of row r = exact match of
    the pattern (SWAR words ``P``, masks ``M``) starting at byte
    ``word_pos[r, w] + a``, clamped to ``limit``.  ``win``: int32[R,
    W + nw - 1], each row's W words and the nw - 1 words after them, which
    its matches may read."""
    W = word_pos.shape[1]
    nib = torch.zeros(word_pos.shape, dtype=torch.int32, device=win.device)
    for a in range(4):
        acc = None
        for k in range(P.shape[1]):
            if Mnp[a, k] == 0:
                continue  # the pattern does not touch this word
            w = win[:, k : k + W]
            eq = (w == P[a, k]) if Mnp[a, k] == -1 else (
                (w & M[a, k]) == P[a, k]
            )
            acc = eq if acc is None else acc & eq
        nib |= acc.to(torch.int32) << a
    keep = (limit - word_pos + 1).clamp(0, 4)
    return nib & ((1 << keep) - 1).to(torch.int32)


def _verify_chunks(x2d, gids, P, M, Mnp, limit: int) -> torch.Tensor:
    """int32[G, 1024] nibble plane of the 4 KiB chunks ``gids``
    (``_verify_words``); a chunk's matches may read into the next chunk's
    first nw words."""
    R = x2d.shape[0]
    nxt = (gids + 1).clamp(max=R - 1)
    win = torch.cat([x2d[gids], x2d[nxt, : P.shape[1]]], dim=1)
    word_pos = gids[:, None] * 4096 + 4 * torch.arange(
        1024, dtype=torch.int64, device=x2d.device
    )[None, :]
    return _verify_words(win, word_pos, P, M, Mnp, limit)


def extract_region(bs, x2d, P, M, m: int, limit: int, capacity: int):
    """(count, offsets, overflow) for the kernel region.

    ``bs``: int32[NB] per-512-byte-block counts from a scan kernel (exact,
    or a candidate superset), clamped in-kernel.  ``x2d``: the (R, 1024)
    word view of the whole padded text (``full_words2d``).  ``limit``: the
    largest valid start, min(n-m, cut-1).  The count is exact; offsets are
    the ascending first ``capacity`` matches."""
    with span("tpumatch.extract"):
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


def extract_region_multi(bs, x2d, Ps, M, m: int, limit: int, capacity: int,
                         pmask: bool) -> list:
    """Per pattern, ``extract_region``'s (count, offsets, overflow).

    ``Ps``: int32[k, 4, nw], the k patterns' SWAR words.  ``bs``: with
    ``pmask``, per-block pattern-hit masks (K6, bit p for pattern p), so
    pattern p verifies only the chunks of the blocks flagged for it;
    otherwise candidate counts over all k targets (K5), which every pattern
    verifies."""
    return [
        extract_region((bs >> p) & 1 if pmask else bs, x2d, Ps[p], M, m,
                       limit, capacity)
        for p in range(Ps.shape[0])
    ]


def extract_blocks(flags, words, Ps, M, cut: int, n: int, m: int,
                   capacity: int, pmask: bool = False) -> list:
    """Per pattern, (count, offsets, overflow) of every start in [0, n - m]
    of the padded text ``words`` (int32[N/4]), from the scan's block flags
    ``flags`` over the kernel region and the tail [cut, N) verified whole:
    ``swar.decode_blocks`` (``pmask``, ``Ps`` and ``M`` as there), then one
    host read, the k counts.  Offsets are the ascending first ``capacity``
    starts, a device tensor each."""
    counts, offsets = swar.decode_blocks(words, flags, Ps, M, cut, n, m,
                                         capacity, pmask)
    return [(c, offsets[p, : min(c, capacity)], c > capacity)
            for p, c in enumerate(counts.tolist())]


def extract_region_multi_groups(bmask, x2d, Ps, M, m: int, limit: int,
                                capacity: int):
    """Per pattern, ``extract_region``'s (count, offsets, overflow) from
    K10c's group occupancy masks (``multi_gather='groups'``, m <= 33).

    ``bmask``: int32[NB], bit g of block b = a candidate start in the
    block's 32-byte group g (over all k targets).  The occupied (block,
    group) pairs are taken once, in ascending order, and each group's 8
    words plus the nw - 1 words after it (clamped at the end of ``x2d``)
    are gathered once; every pattern verifies every gathered group with
    the chunk verify's masked word compares (``_verify_words``), clamped
    to ``limit``, and is exact on its own with its own ``capacity``.  A true start is a
    candidate, so its group is occupied.  More occupied groups than the
    gather width return None: the caller decodes the block flags
    (``extract_blocks``)."""
    with span("tpumatch.extract"):
        Mnp = swar.mask_words(m)
        nw = Mnp.shape[1]
        blocks = extract.sorted_nonzero_ids(bmask)
        shifts = torch.arange(16, dtype=torch.int32, device=bmask.device)
        bits = (bmask[blocks][:, None] >> shifts) & 1
        occ = extract.sorted_nonzero_ids(bits.flatten())
        gids = blocks[occ // 16] * 16 + occ % 16  # 16 * block + group, ascending
        if gids.numel() > MULTI_BLOCK_TIER:
            return None
        flat = x2d.view(-1)
        idx = (gids[:, None] * GROUP_WORDS
               + torch.arange(GROUP_WORDS + nw - 1, device=gids.device)[None, :])
        slab = flat[idx.clamp(max=flat.numel() - 1)]
        word_pos = (gids[:, None] * (4 * GROUP_WORDS)
                    + 4 * torch.arange(GROUP_WORDS, device=gids.device)[None, :])
        out = []
        for P in Ps:
            nib = _verify_words(slab, word_pos, P, M, Mnp, limit)
            pos = extract.nib_positions(nib, gids * (4 * GROUP_WORDS))
            count = pos.numel()
            out.append((count, pos[:capacity], count > capacity))
        return out


def _dense(nb: int, x2d, P, M, limit: int, capacity: int):
    """Full naive rescan of the region's ``nb`` blocks (K2): exact verify
    of every position, then decode only the blocks that hold one of the
    first ``capacity`` matches."""
    with span("tpumatch.rescan"):
        nib, bs2 = swar.naive_nib(x2d.view(-1)[: nb * 128], limit, P, M)
        return emit.nibble_to_matches(nib, bs2, capacity)
