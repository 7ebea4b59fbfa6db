"""Nibble planes to ascending byte offsets (counterpart of the parts of the
JAX ``ops/extract.py`` that its extraction uses), for the group extraction
and the ``nib`` routes' decode.

The reference compacts with sorts and fixed-size T-slot planes because the
TPU has no dynamic shapes, and gives up to the drain path when a plane
overflows.  PyTorch's ``nonzero`` returns exactly the set positions in
ascending order, so none of that machinery is needed and no path gives up.
"""

from __future__ import annotations

import torch


def sorted_nonzero_ids(flags: torch.Tensor) -> torch.Tensor:
    """Ascending int64 indices where ``flags`` is nonzero."""
    return torch.nonzero(flags).flatten()


def nib_positions(rows: torch.Tensor, row_base: torch.Tensor) -> torch.Tensor:
    """Ascending int64 byte positions of every set nibble bit.

    ``rows``: int32[R, C] nibble words, bit a of word c of row r = match at
    byte ``row_base[r] + 4c + a``.  ``row_base`` must ascend with rows
    that do not overlap, so the row-major order of ``nonzero`` is
    ascending position order."""
    R, C = rows.shape
    shifts = torch.arange(4, dtype=torch.uint8, device=rows.device)
    # Nibbles fit in a byte: decode one byte per (word, alignment).
    bits = (rows.to(torch.uint8).unsqueeze(-1) >> shifts) & 1
    flat = torch.nonzero(bits.flatten()).flatten()
    return row_base.to(torch.int64)[flat // (4 * C)] + flat % (4 * C)
