"""Boyer-Moore's lane-cursor skip loop (counterpart of the JAX
``ops/boyer_moore.py::bm_start_mask_cursor``, ``bm_variant='cursor'``).

The text splits into L = ceil(n / chunk) lanes of ``chunk`` bytes, each
with one cursor at its first byte.  Every step compares each active
cursor's m-byte window with the pattern, right to left as Boyer-Moore does,
and moves the cursor by the larger of the bad-character and good-suffix
shifts (the period after a full match).  Lanes step in lockstep and a lane
is active while its cursor is inside its chunk, so the step count is set by
the slowest lane.  A window may run past its lane into the next: matches
across lane seams are found by the lane they start in.

The reference runs this as an XLA ``while_loop`` and has no Pallas kernel
for it; here it is plain PyTorch on the text's device.
"""

from __future__ import annotations

import torch


def bm_start_mask_cursor(text: torch.Tensor, pattern: torch.Tensor,
                         bad_char: torch.Tensor, good_suffix: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """bool[n] exact start mask of ``pattern`` (uint8[m]) in ``text``
    (uint8[n]), with lanes of ``chunk`` bytes; a window reaching past the
    text reads zeros.

    ``bad_char``: int32[256], the last index of each byte in the pattern,
    -1 if absent; ``good_suffix``: int32[m+1], ``good_suffix[j+1]`` the shift
    on a mismatch at pattern index j and ``good_suffix[0]`` the shift after a
    full match (``ops/tables.bm_bad_char`` / ``bm_good_suffix``)."""
    n_pos = text.shape[0]
    m = pattern.shape[0]
    dev = text.device
    c = min(chunk, n_pos)
    lanes = -(-n_pos // c)
    total = lanes * c
    padded = torch.cat([text, text.new_zeros(total + m - n_pos)])
    cursor = torch.arange(lanes, device=dev) * c
    ends = cursor + c
    offs = torch.arange(m, device=dev)
    bad_char = bad_char.to(torch.int64)
    good_suffix = good_suffix.to(torch.int64)
    # One slot past the text takes the writes of inactive lanes.
    mask = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    while True:
        active = cursor < ends
        # The loop's condition is a host sync on every step, as the
        # reference's while_loop condition is a device-side any().
        if not bool(active.any()):
            break
        cur = cursor.clamp(max=total - 1)
        window = padded[cur[:, None] + offs]
        eq = window == pattern[None, :]
        full = eq.all(1)
        # Rightmost mismatch (m - 1 where there is none; unused there).
        j_mis = (m - 1) - torch.argmax((~eq).flip(1).to(torch.uint8), dim=1)
        mis_byte = window.gather(1, j_mis[:, None])[:, 0]
        bc_shift = j_mis - bad_char[mis_byte.to(torch.int64)]
        gs_shift = good_suffix[j_mis + 1]
        shift = torch.where(full, good_suffix[0],
                            torch.maximum(bc_shift, gs_shift).clamp(min=1))
        # A lane visits each position at most once (every shift is >= 1),
        # and the active lanes' positions are distinct, so a plain store is
        # the reference's max-scatter.
        mask[torch.where(active, cur, total)] = full & active
        cursor = torch.where(active, cursor + shift, cursor)
    return mask[:n_pos]
