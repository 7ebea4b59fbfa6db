"""Counterpart of ``exp/proto_kernels.py``: the screen fed by a word or a
block view (K11c), and the gather-verify path over 4 KiB groups (K11d), on
the card.

The path (``gv_offsets``): the probe screen counts candidates per 512-byte
block; ``group_ids`` lists the first ``cap_g`` 4 KiB groups (eight blocks)
that hold one; ``gather_verify`` runs the exact verify of those groups
alone in one launch; ``nib_rows_to_offsets`` decodes their nibble rows into
ascending byte offsets.  The reference gathers the groups through
scalar-prefetched block specs and crashed Mosaic on its block-view screen;
on the card both views are one flat word array.  Run on the card:

    python -m parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp.proto_kernels
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..kernels import swar
from ..models.algorithms import BoyerMooreMatcher
from ..models.base import resolve_device, to_device
from ..ops import extract
from ..utils.config import MatchConfig
from ..utils.io import gen_english, pad_to_multiple
from .screen_kernel_opt import C, fmt_ms, mask_on, timer

W = C // 4                 # words per tile row
TILE_WORDS = 128 * W       # the reference's 512 KiB screen tile
GROUP_BYTES = 4 * swar.GROUP_WORDS
CAP_GS = (1024, 2048, 4096)


def proto_screen(words: torch.Tensor, n: int, P: torch.Tensor, m: int,
                 probes, from_blocks: bool = False):
    """``exp/proto_kernels.py:132`` ``proto_screen`` (K11c): (cnt, bs) of
    the screen with the full epilogue (``swar.screen_cand_nibsums``, K11a's
    function) over the text's int32 words, given as the (L, 1024) word view
    or, with ``from_blocks``, the (nb, 128) block view.  The text must be
    whole 512 KiB tiles; starts are valid up to min(n, N) - m.  bs is
    int32[N/512] in byte order, cnt the int32 total."""
    width = 128 if from_blocks else W
    if words.dim() != 2 or words.shape[1] != width:
        raise ValueError(f"words must be (rows, {width}), got {tuple(words.shape)}")
    flat = words.reshape(-1)
    if flat.numel() % TILE_WORDS:
        raise ValueError(f"the text must be whole {4 * TILE_WORDS}-byte tiles")
    n_lim = min(n, 4 * flat.numel()) - m
    bs, cnt = swar.screen_cand_nibsums(flat, n_lim, P, mask_on(m, flat.device),
                                       probes)
    return cnt, bs


def gather_verify(blocks: torch.Tensor, g8ids: torch.Tensor, nlim: int,
                  P: torch.Tensor, m: int, cap_g: int):
    """``exp/proto_kernels.py:238`` ``gather_verify`` (K11d): (nib, cnt,
    bsr) of the exact verify of the ``cap_g`` listed 4 KiB groups
    ``g8ids`` (int32; the fill id nb // 8 gives zero rows) of the (nb, 128)
    block view ``blocks``, starts valid up to ``nlim``.  nib is
    int32[cap_g, 8, 128] (bit a of word c of row r of group i = match at
    byte 4096 g8ids[i] + 512 r + 4c + a), bsr int32[8 cap_g] its row
    popcounts, cnt their int32 total."""
    if blocks.dim() != 2 or blocks.shape[1] != 128:
        raise ValueError(f"blocks must be (nb, 128), got {tuple(blocks.shape)}")
    if tuple(g8ids.shape) != (cap_g,):
        raise ValueError(f"g8ids must hold cap_g={cap_g} ids, got {tuple(g8ids.shape)}")
    nib, bsr, cnt = swar.gather_verify(blocks.reshape(-1), g8ids, nlim, P,
                                       mask_on(m, blocks.device))
    return nib, cnt, bsr


def group_ids(bs: torch.Tensor, cap_g: int) -> torch.Tensor:
    """int32[cap_g]: the first ``cap_g`` 4 KiB groups whose eight block sums
    ``bs`` are not all zero, ascending, padded with the fill id nb // 8
    (``emit.masked_positions(bs4k > 0, cap_g, fill=nb8)`` of
    ``exp/proto_kernels.py:352-353``)."""
    if bs.numel() % 8:
        raise ValueError(f"block sums must cover whole groups, got {bs.numel()}")
    occupied = extract.sorted_nonzero_ids(bs.view(-1, 8).sum(1) > 0)[:cap_g]
    ids = torch.full((cap_g,), bs.numel() // 8, dtype=torch.int32,
                     device=bs.device)
    ids[: occupied.numel()] = occupied.to(torch.int32)
    return ids


def nib_rows_to_offsets(nib: torch.Tensor, bsr: torch.Tensor, cnt,
                        capacity: int, g8: torch.Tensor):
    """(count, offsets[:capacity], overflow) of gather-verify rows: the
    decode local to the reference's ``main`` (``exp/proto_kernels.py:314-348``).
    Only the rows holding one of the first ``capacity`` matches are
    decoded; row j starts at byte 4096 g8[j // 8] + 512 (j mod 8)."""
    count = int(cnt)
    before = torch.cumsum(bsr, 0) - bsr
    rows = extract.sorted_nonzero_ids((bsr > 0) & (before < capacity))
    base = g8.to(torch.int64)[rows // 8] * GROUP_BYTES + (rows % 8) * swar.BLOCK_BYTES
    pos = extract.nib_positions(nib.reshape(-1, swar.BLOCK_WORDS)[rows], base)
    return count, pos[:capacity], count > capacity


def verify_groups(words: torch.Tensor, bs: torch.Tensor, n: int,
                  P: torch.Tensor, m: int, cap_g: int, capacity: int | None):
    """The path after the screen: group ids from the block sums ``bs``,
    their gather-verify, and (unless ``capacity`` is None) the decode."""
    g8 = group_ids(bs, cap_g)
    nib, cnt, bsr = gather_verify(words.view(-1, 128), g8, n - m, P, m, cap_g)
    if capacity is None:
        return cnt
    return nib_rows_to_offsets(nib, bsr, cnt, capacity, g8)


def gv_offsets(words: torch.Tensor, n: int, P: torch.Tensor, m: int, probes,
               cap_g: int, capacity: int):
    """The reference's ``make_gv(cap_g)`` (``exp/proto_kernels.py:350-359``):
    (count, offsets[:capacity], overflow) of the pattern (``P``, ``m``,
    ``probes`` as for ``swar.screen_cand_bsums``) in the text of logical
    length ``n`` whose int32 words ``words`` holds (whole 512 KiB tiles).
    The screen, the group ids, the gather-verify and the decode, chained.

    When the groups holding a candidate number at most ``cap_g``, this is
    every match: count exact, offsets the first ``capacity``.  When they
    number more, only the first ``cap_g`` groups are verified, as in the
    reference: count and offsets cover the matches in those groups
    alone."""
    flat = words.reshape(-1)
    _, bs = proto_screen(flat.view(-1, W), n, P, m, probes)
    return verify_groups(flat, bs, n, P, m, cap_g, capacity)


def find_all(text: bytes, pattern: bytes) -> list[int]:
    """Every (overlapping) start of ``pattern`` in ``text``, ascending."""
    out, i = [], text.find(pattern)
    while i != -1:
        out.append(i)
        i = text.find(pattern, i + 1)
    return out


def main(device=None, n: int = 256 << 20) -> int:
    """The reference's ``main`` (``exp/proto_kernels.py:262-378``) on the
    card: on ``n`` bytes of seeded English, m=16, the screen from the word
    and the block view against K1, the screens' times, and for cap_g 1024,
    2048 and 4096 the "kernel+gids" (group ids and gather-verify) and "full
    recon" (and the decode) times and whether the offsets equal the
    oracle's.  Returns 1 when a check fails."""
    dev = resolve_device("cuda" if device is None else device)
    time_ms, label = timer(dev)
    print(f"device: {dev} {label}", flush=True)
    pattern = b"quick brown fox "
    m = len(pattern)
    text = gen_english(n, seed=42)
    padded = pad_to_multiple(np.frombuffer(text, np.uint8), 4 * TILE_WORDS)
    matcher = BoyerMooreMatcher(pattern, MatchConfig(), device=dev)
    P, probes = matcher.dev_tables["swar_p"], matcher.config.bm_probe_layout
    capacity = matcher.config.capacity
    words = to_device(padded, dev).view(torch.int32)
    w2, wb = words.view(-1, W), words.view(-1, 128)

    # The shipped screen (K1) over the kernel region, as the reference's
    # "old reference bsums".
    Nk, cut = swar.kernel_region(padded.size, m, C)
    screen_old = functools.partial(swar.screen_cand_bsums, words[: Nk // 4],
                                   min(n - m, cut - 1), P, matcher.swar_m, probes)
    bs_o = screen_old()
    _, bs_p = proto_screen(w2, n, P, m, probes)
    _, bs_b = proto_screen(wb, n, P, m, probes, from_blocks=True)
    ok = torch.equal(bs_b, bs_p)
    print(f"proto screen 2d:  bs equal={torch.equal(bs_p[: bs_o.numel()], bs_o)}  "
          f"sum_p={int(bs_p.sum())} sum_o={int(bs_o.sum())}; block view equal "
          f"to 2d={ok}", flush=True)
    t_new = time_ms(functools.partial(proto_screen, w2, n, P, m, probes))
    print(f"screen 2d:  {fmt_ms(t_new, n)} {label}", flush=True)
    print(f"screen old: {fmt_ms(time_ms(screen_old), n)} {label}", flush=True)

    want = [o for o in find_all(text, pattern) if o <= n - m]
    occupied = int((bs_p.view(-1, 8).sum(1) > 0).sum())
    print(f"groups holding a candidate: {occupied}", flush=True)
    for cap_g in CAP_GS:
        count, offs, _ = gv_offsets(words, n, P, m, probes, cap_g, capacity)
        same = count == len(want) and offs.tolist() == want[:capacity]
        ok &= same or occupied > cap_g  # past cap_g the groups are cut
        tk = time_ms(functools.partial(verify_groups, words, bs_p, n, P, m,
                                       cap_g, None))
        tf = time_ms(functools.partial(verify_groups, words, bs_p, n, P, m,
                                       cap_g, capacity))
        print(f"cap_g={cap_g}: kernel+gids {fmt_ms(tk, n)}, full recon "
              f"{fmt_ms(tf, n)}, count={count}, offsets==oracle: {same} {label}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
