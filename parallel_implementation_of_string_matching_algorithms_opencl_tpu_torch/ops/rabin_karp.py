"""Rabin-Karp window hashes and exact start mask (counterpart of the JAX
``ops/rabin_karp.py``).

Serves the region after the kernel's cut, texts shorter than one kernel
tile, m = 1 and patterns longer than ``kernels.rk_roll.MAX_RK_PATTERN``,
for one pattern and for k equal-length patterns, and the plain versions of
the rolling-hash kernels.

Hashes are uint32 values mod 2**32 (``ops/tables.rk_hash``).  PyTorch's
uint32 support is partial, so they are held in int64: every term
byte * B^k is below 2**40, a sum of up to 2**23 of them cannot overflow,
and one ``& 0xFFFFFFFF`` at the end gives the wrapped value.
"""

from __future__ import annotations

import torch

from .naive import naive_start_mask

# Candidate-verification width of the reference (``verify_capacity``).
DEFAULT_VERIFY_CAPACITY = 131072
# Windows x m up to this many elements are hashed in one multiply-sum;
# larger texts take one pass per pattern byte.
_UNFOLD_ELEMENTS = 1 << 24

MASK32 = 0xFFFFFFFF


def rk_window_hashes(text: torch.Tensor, powers: torch.Tensor) -> torch.Tensor:
    """int64[N] of window hashes H[i] = sum_j text[i+j] * powers[j] mod
    2**32, reading zeros past the end.  ``powers``: int64[m], the uint32
    values B^(m-1-j)."""
    n_pos = text.shape[0]
    m = powers.shape[0]
    padded = torch.cat([text, text.new_zeros(m)]).to(torch.int64)
    if n_pos * m <= _UNFOLD_ELEMENTS:
        h = (padded.unfold(0, m, 1)[:n_pos] * powers).sum(1)
    else:
        h = padded[:n_pos] * powers[0]
        for j in range(1, m):
            h += padded[j : j + n_pos] * powers[j]
    return h & MASK32


def verify_positions(text: torch.Tensor, pattern: torch.Tensor,
                     pos: torch.Tensor,
                     verify_capacity: int = DEFAULT_VERIFY_CAPACITY):
    """The candidate starts ``pos`` (int64, ascending) at which ``pattern``
    matches ``text``, in order.  Up to ``verify_capacity`` candidates are
    verified by a gathered window compare; more take a full shifted
    compare, which bounds the gather's memory as the reference's fallback
    does.  Windows read zeros past the end."""
    n_pos = text.shape[0]
    m = pattern.shape[0]
    if pos.numel() > min(verify_capacity, n_pos):
        return pos[naive_start_mask(text, pattern)[pos]]
    padded = torch.cat([text, text.new_zeros(m)])
    win = padded[pos[:, None] + torch.arange(m, device=text.device)]
    return pos[(win == pattern).all(1)]


def verify_candidates(text: torch.Tensor, pattern: torch.Tensor,
                      cand: torch.Tensor,
                      verify_capacity: int = DEFAULT_VERIFY_CAPACITY):
    """Exact start mask restricted to the candidates ``cand`` (bool[N]),
    by ``verify_positions``."""
    idx = torch.nonzero(cand).flatten()
    out = torch.zeros(text.shape[0], dtype=torch.bool, device=text.device)
    out[verify_positions(text, pattern, idx, verify_capacity)] = True
    return out


def verify_region(text: torch.Tensor, pattern: torch.Tensor,
                  cand: torch.Tensor, n_cand: int, limit: int,
                  verify_capacity: int, capacity: int):
    """(count, offsets[:capacity], overflow) of the matches that start in
    [0, limit] of ``text``, from the region's ``n_cand`` hash candidates,
    of which ``cand`` holds the first min(n_cand, verify_capacity)
    ascending (the ``emission='nib'`` route of the reference's
    ``_verify_region``).  Up to ``verify_capacity`` candidates are verified
    at their windows; more take an exact shifted compare of the region
    clamped to ``limit``, so the count is exact either way."""
    m = pattern.shape[0]
    if n_cand > verify_capacity:
        head = max(limit + 1, 0)
        mask = naive_start_mask(text[: head + m - 1], pattern)[:head]
        pos = torch.nonzero(mask).flatten()
    else:
        pos = verify_positions(text, pattern, cand, verify_capacity)
    count = pos.numel()
    return count, pos[:capacity], count > capacity


def rk_start_mask(text: torch.Tensor, pattern: torch.Tensor,
                  powers: torch.Tensor, pattern_hash,
                  verify_capacity: int = DEFAULT_VERIFY_CAPACITY):
    """Exact start mask via hash screen + verification (single pattern);
    ``pattern_hash`` is the pattern's uint32 hash as an int or a tensor."""
    cand = rk_window_hashes(text, powers) == pattern_hash
    return verify_candidates(text, pattern, cand, verify_capacity)


def rk_multi_start_masks(text: torch.Tensor, patterns: torch.Tensor,
                         powers: torch.Tensor, pattern_hashes: torch.Tensor,
                         verify_capacity: int = DEFAULT_VERIFY_CAPACITY):
    """Exact start masks of k equal-length patterns, bool[k, N]: the window
    hashes are computed once, then each pattern takes a compare and its own
    candidate verification.  ``patterns``: uint8[k, m]; ``pattern_hashes``:
    int64[k] uint32 values."""
    h = rk_window_hashes(text, powers)
    return torch.stack([
        verify_candidates(text, patterns[p], h == pattern_hashes[p],
                          verify_capacity)
        for p in range(patterns.shape[0])
    ])
