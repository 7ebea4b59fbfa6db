"""KMP dense-DFA start mask (counterpart of the JAX ``ops/kmp.py``).

Serves the region after the kernel's cut, texts shorter than one kernel
tile and patterns the Shift-AND kernel does not run (m > 509, or m > 256
with ``kmp_long='ripple'``).

The failure function is densified on the host into an ``(m+1, 256)`` DFA
(``ops/tables.kmp_dfa``) and each step is the branchless gather
``state = dfa[state, byte]``.  The text is split into lanes of ``chunk``
bytes; lane l scans bytes [l*chunk, (l+1)*chunk + m - 1) from state 0 and
reports the matches starting in its own chunk, since a match starting at s
depends only on bytes [s, s+m).  The scan over steps is a Python loop, each
step vectorised over the lanes: one small launch per step on a GPU.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 2048


def kmp_start_mask(text: torch.Tensor, dfa: torch.Tensor,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """bool[N] exact start mask of the pattern whose DFA (int32[m+1, 256])
    is ``dfa``, reading zeros past the end of ``text`` (uint8[N])."""
    n_pos = text.shape[0]
    m = dfa.shape[0] - 1
    if m > n_pos:
        return torch.zeros(n_pos, dtype=torch.bool, device=text.device)
    c = min(chunk, n_pos)
    if m - 1 > c:
        # A lane's (m-1)-byte halo comes from the next chunk only, so chunks
        # must be at least m-1 long; otherwise scan in a single lane.
        c = n_pos
    lanes = -(-n_pos // c)
    total = lanes * c
    padded = torch.cat([text, text.new_zeros(total + c - n_pos)])
    base = padded[:total].view(lanes, c)
    halo = padded[c : c + total].view(lanes, c)[:, : m - 1]
    # (c+m-1, L): row t holds byte t of every lane.
    cols = torch.cat([base, halo], dim=1).t().contiguous().to(torch.int64)
    dfa_flat = dfa.reshape(-1).to(torch.int64)
    state = torch.zeros(lanes, dtype=torch.int64, device=text.device)
    hits = torch.empty((c + m - 1, lanes), dtype=torch.bool,
                       device=text.device)
    for t in range(c + m - 1):
        state = dfa_flat[state * 256 + cols[t]]
        hits[t] = state == m
    # A match ending at lane-local step t starts at t - (m-1); a lane owns
    # the starts in [0, c).
    return hits[m - 1 :].t().reshape(total)[:n_pos]
