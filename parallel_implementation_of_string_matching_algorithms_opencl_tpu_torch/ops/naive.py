"""Naive shifted-compare start mask (counterpart of the JAX ``ops/naive.py``).

Serves the region after the kernels' cut, texts shorter than one kernel tile
and patterns longer than ``kernels.swar.MAX_PATTERN``.
"""

from __future__ import annotations

import torch


def naive_start_mask(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """bool[N]: mask[i] == (text[i:i+m] == pattern), reading zeros past the
    end.  Positions whose window crosses the end of the valid text must be
    cleared by the caller (``emit.valid_start_mask``): a pattern ending in
    NUL bytes would otherwise match inside the zero padding."""
    n_pos = text.shape[0]
    m = pattern.shape[0]
    padded = torch.cat([text, text.new_zeros(m)])
    mask = padded[0:n_pos] == pattern[0]
    for j in range(1, m):
        mask &= padded[j : j + n_pos] == pattern[j]
    return mask
