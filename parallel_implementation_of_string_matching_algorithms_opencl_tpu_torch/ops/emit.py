"""Start masks to (count, offsets, overflow) (counterpart of the JAX
``ops/emit.py``).

Offsets are int64 tensors holding the ascending first ``capacity`` match
positions: PyTorch has dynamic shapes, so the reference's FILL-padded
fixed-capacity buffers and their rank-select tiers have no counterpart.
Counts are Python ints and always exact.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import extract


def mask_to_matches_sorted(mask: torch.Tensor, capacity: int):
    """(count, offsets[:capacity], overflow) of a bool start mask.  One
    ``nonzero`` serves both of the reference's extractors (the sort-based
    one for small masks and the rank-select ``mask_to_matches``)."""
    pos = torch.nonzero(mask).flatten()
    count = pos.numel()
    return count, pos[:capacity], count > capacity


def valid_start_mask(mask: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Clear positions beyond ``n - m``: they cannot start a match in a
    text of logical length ``n`` (padding / halo tail)."""
    pos = torch.arange(mask.shape[0], device=mask.device)
    return mask & (pos <= n - m)


def merge_region_matches(c1, o1, v1, c2, o2, v2, capacity: int, offset2: int):
    """Merge a kernel region's (count, offsets, overflow) with a tail region
    starting at byte ``offset2``; every region-1 offset precedes every
    region-2 offset."""
    count = c1 + c2
    out = torch.cat([o1, o2 + offset2])[:capacity]
    return count, out, v1 or v2 or count > capacity


def merge_tail(c1, o1, v1, cut: int, n: int, m: int, capacity: int,
               tail_mask: torch.Tensor):
    """Merge an extracted kernel region [0, cut) with the bool start mask
    ``tail_mask`` over the tail [cut, N) of a text of logical length n."""
    if tail_mask.shape[0] == 0:
        return c1, o1, v1
    with span("tpumatch.tail"):
        tail_valid = valid_start_mask(tail_mask, n - cut, m)
        c2, o2, v2 = mask_to_matches_sorted(
            tail_valid, min(capacity, tail_mask.shape[0])
        )
        return merge_region_matches(c1, o1, v1, c2, o2, v2, capacity, cut)


def nibble_to_matches(nib: torch.Tensor, bs: torch.Tensor, capacity: int):
    """(count, offsets[:capacity], overflow) of a kernel's nibble plane.

    ``nib``: int32[Nw], bit a of word w = a set position at byte 4w + a,
    with validity already applied in the kernel; ``bs``: int32[Nw/128], the
    popcount of each 512-byte block.  The count is ``bs.sum()``; only the
    blocks that hold one of the first ``capacity`` positions are decoded,
    so the plane is never expanded whole.  Counterpart of the reference's
    ``nibble_to_matches`` with kernel block sums."""
    count = int(bs.sum())
    before = torch.cumsum(bs, 0) - bs
    blocks = extract.sorted_nonzero_ids((bs > 0) & (before < capacity))
    pos = extract.nib_positions(nib.view(-1, 128)[blocks], blocks * 512)
    return count, pos[:capacity], count > capacity
