"""Corpora made on the device from a seed, in a few large calls.

A corpus kind is a file of its own, ``corpora/<kind>.py``, whose
``fill(out, n, g)`` writes ``out[:n]`` from the ``torch.Generator`` g.  The
same seed on the same device gives the same bytes; the stream is
``torch.Generator``'s, not numpy's.
"""

from __future__ import annotations

import torch

from . import manifest

CHUNK = 1 << 26


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**64 - 1))
    return g


def make(kind: str, n: int, padded: int, seed: int, device,
         root=None) -> torch.Tensor:
    """A uint8 tensor of ``padded`` bytes on ``device``: the corpus in the
    first n, zeros after it."""
    out = torch.zeros(padded, dtype=torch.uint8, device=device)
    manifest.plugin("corpora", kind, root).fill(out, n,
                                                generator(seed, out.device))
    return out
