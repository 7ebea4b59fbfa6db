"""Start masks to (count, offsets, overflow) (counterpart of the JAX
``ops/emit.py``).

Offsets are int64 tensors holding the ascending first ``capacity`` match
positions: PyTorch has dynamic shapes, so the reference's FILL-padded
fixed-capacity buffers and their rank-select tiers have no counterpart.
Counts are Python ints and always exact.
"""

from __future__ import annotations

import torch


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
