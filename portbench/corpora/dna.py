"""Bytes drawn uniformly from ``ACGT`` (BASELINE config 4's DNA)."""

import torch

from portbench import corpus


def fill(out: torch.Tensor, n: int, g: torch.Generator) -> None:
    for a in range(0, n, corpus.CHUNK):
        c = torch.randint(0, 4, (min(corpus.CHUNK, n - a),), generator=g,
                          device=out.device, dtype=torch.uint8)
        # 0, 1, 2, 3 -> 'A' 65, 'C' 67, 'G' 71, 'T' 84
        out[a : a + c.numel()] = 65 + 2 * (c >= 1) + 4 * (c >= 2) + 13 * (c >= 3)
