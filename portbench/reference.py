"""The plain reference: every overlapping occurrence of a byte pattern, by
direct comparison of each byte.

It imports nothing of the repository's packages and takes nothing the
program made: the text is the benchmark's own corpus, the pattern its own
bytes.  It runs on whatever device holds the text, in chunks, so a 1 GB
text fits beside the program's memory.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 28


def find_all(text: torch.Tensor, n: int, pattern: bytes,
             compared: int | None = None) -> np.ndarray:
    """Sorted int64 starts p with ``text[p:p+m] == pattern`` and p + m <= n
    (``text``: uint8, at least n bytes).  ``compared`` < m compares only
    the first ``compared`` bytes, at the same starts: the control's
    weakened answer, never the reference's."""
    m = len(pattern)
    use = m if compared is None else compared
    if m == 0 or m > n:
        return np.empty(0, np.int64)
    pat = torch.tensor(list(pattern), dtype=torch.uint8, device=text.device)
    starts = n - m + 1
    parts = []
    for a in range(0, starts, CHUNK):
        span = min(CHUNK, starts - a)
        hit = text[a : a + span] == pat[0]
        for j in range(1, use):
            hit &= text[a + j : a + j + span] == pat[j]
        parts.append(torch.nonzero(hit).flatten() + a)
    return torch.cat(parts).cpu().numpy().astype(np.int64)


def truncated(m: int) -> int:
    """Bytes the control compares of an m-byte pattern: the first half, at
    most 8."""
    return min(8, -(-m // 2))
