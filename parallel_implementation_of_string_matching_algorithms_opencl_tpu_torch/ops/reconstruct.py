"""Block flags to (count, offsets, overflow) per pattern (counterpart of
the JAX ``ops/reconstruct.py``'s ``full_words2d`` and multi-pattern
``extract_region_multi_groups``; its ``extract_region`` and
``extract_region_multi*`` give way to the decode).

A scan kernel's block flags mark which 512-byte blocks may hold matches:
exact counts from the naive verify (and the KMP automaton for m <= 32), a
candidate superset from the Boyer-Moore probe screen, the Rabin-Karp hash
screen and the KMP ``pattern[:32]`` screen, or per-pattern hit masks.
``extract_blocks`` hands them to ``swar.decode_blocks``, which verifies the
flagged blocks where they lie and the tail the scan did not cover, for
every pattern, and reads the counts back once: a CUDA kernel on the card,
its plain version (``swar.decode_blocks_plain``) on the CPU.  The group
extraction of ``multi_gather='groups'`` keeps its own gather on both.

Offsets are always the true ascending first ``capacity`` matches: the
reference's tier switch, T-slot extraction, shared union gather, side
planes and give-up paths are TPU machinery with no counterpart here.
"""

from __future__ import annotations

import torch

from ..kernels import swar
from ..utils.profiling import span
from . import extract

# Gather width of the group extraction in occupied 32-byte groups: the
# reference's largest multi-pattern gather tier, MULTI_BLOCK_TIERS[-1].
# More occupied groups than this take the decode of the block flags.
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
    """Per pattern, (count, offsets, overflow) over [0, ``limit``] from
    K10c's group occupancy masks (``multi_gather='groups'``, m <= 33).

    ``bmask``: int32[NB], bit g of block b = a candidate start in the
    block's 32-byte group g (over all k targets).  The occupied (block,
    group) pairs are taken once, in ascending order, and each group's 8
    words plus the nw - 1 words after it (clamped at the end of ``x2d``)
    are gathered once; every pattern verifies every gathered group with
    masked word compares (``_verify_words``), clamped to ``limit``, and is
    exact on its own with its own ``capacity``.  A true start is a
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

