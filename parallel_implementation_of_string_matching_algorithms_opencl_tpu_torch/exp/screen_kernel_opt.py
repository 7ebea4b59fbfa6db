"""Counterpart of ``exp/screen_kernel_opt.py``: the variants of the
Boyer-Moore candidate screen, on the card.

The reference times four variants of its screen kernel against the shipped
one (V0, K1) at 256 MiB English, m=16, 'table_gs' probes:

- V1 (kind ``'v1'``, K11a): the screen with the full epilogue, counting
  (word, alignment) candidates per 512-byte block and in total
  (``swar.screen_cand_nibsums``);
- V2-V4 (kind ``'v2'``, K11b, R = 128, 256 and 512 rows per tile): the
  lite epilogue, the count of words with any alignment hit, which is K1's
  function (``swar.screen_cand_bsums``).  R only sets the region,
  Nk = floor(N / (R * 4096)) * R * 4096.

The reference's narrow halo roll and tile shapes are TPU layout: on the
card every variant reads the same flat word array.  Run on the card:

    python -m parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp.screen_kernel_opt
"""

from __future__ import annotations

import functools
import subprocess
import sys

import numpy as np
import torch

from ..kernels import swar
from ..models.base import resolve_device, to_device
from ..utils.io import gen_english, pad_to_multiple

C = 4096      # bytes per tile row (the reference's chunk)
ITERS = 16    # calls per timed pass
PASSES = 3    # timed passes; the best is reported


@functools.lru_cache(maxsize=64)
def mask_on(m: int, device: torch.device) -> torch.Tensor:
    """``swar.mask_words(m)`` on ``device`` (made once per m and device)."""
    return torch.from_numpy(swar.mask_words(m)).to(device)


def run_variant(kind: str, words: torch.Tensor, n: int, P: torch.Tensor,
                m: int, probes, R: int = 128):
    """``exp/screen_kernel_opt.py:192`` ``run_variant``: (cnt, bs) of screen
    variant ``kind`` over the region of the first Nk = floor(N / (R * C))
    * R * C bytes of the text, whose int32 words ``words`` holds (any
    contiguous view; N = 4 * words.numel()).  Starts are valid up to
    min(n, Nk) - m.

    ``'v1'`` (K11a): bs counts the (word, alignment) candidates of each
    512-byte block; ``'v2'`` (K11b, K1): bs counts the words with a
    candidate alignment, clamped per word.  bs is int32[Nk/512] in byte
    order, cnt the int32 total."""
    if kind not in ("v1", "v2"):
        raise ValueError(f"kind must be 'v1' or 'v2', got {kind!r}")
    if R < 1:
        raise ValueError(f"R must be positive, got {R}")
    flat = words.reshape(-1)
    tile = R * C
    Nk = (flat.numel() * 4 // tile) * tile
    n_lim = min(n, Nk) - m
    region, M = flat[: Nk // 4], mask_on(m, flat.device)
    if kind == "v1":
        bs, cnt = swar.screen_cand_nibsums(region, n_lim, P, M, probes)
    else:
        bs = swar.screen_cand_bsums(region, n_lim, P, M, probes)
        cnt = bs.sum(dtype=torch.int32)
    return cnt, bs


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def best_ms(fn, iters: int = ITERS, passes: int = PASSES) -> float:
    """Best over ``passes`` of the mean time of ``iters`` calls of ``fn()``
    in ms, from CUDA events around each pass, after one warm call."""
    fn()
    best = None
    for _ in range(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end) / iters
        best = t if best is None else min(best, t)
    return best


def timer(device: torch.device):
    """(time of ``fn`` in ms or None, label): CUDA events and the card's
    name and power limit on the card; on the CPU nothing is timed."""
    if device.type != "cuda":
        return (lambda fn: None), "[cpu: times not measured]"
    return best_ms, f"[{card()}]"


def fmt_ms(t, n: int) -> str:
    return "not measured" if t is None else f"{t:.4f} ms ({n / t / 1e6:.1f} GB/s)"


def main(device=None, n: int = 256 << 20) -> int:
    """The reference's ``main`` (``exp/screen_kernel_opt.py:214``): V0 (K1)
    and V1-V4 on ``n`` bytes of seeded English, m=16, 'table_gs' probes;
    each variant's time and its block sums against V0's (bit-exact,
    same-set or MISMATCH).  Returns 1 on a MISMATCH."""
    dev = resolve_device("cuda" if device is None else device)
    time_ms, label = timer(dev)
    print(f"device: {dev} {label}", flush=True)
    text = gen_english(n, seed=42)
    padded = pad_to_multiple(np.frombuffer(text, np.uint8), 1024)
    pattern = b"quick brown fox "
    m = len(pattern)
    u = np.frombuffer(pattern, np.uint8)
    P = torch.from_numpy(swar.pattern_words(u)[0]).to(dev)
    probes = swar.static_probes_from_table(swar.probe_table(u, use_gs=True))
    words = to_device(padded, dev).view(torch.int32)

    # V0: the shipped screen (K1) over the kernel region, the 512 KiB tile.
    Nk, cut = swar.kernel_region(padded.size, m, C)
    v0 = functools.partial(swar.screen_cand_bsums, words[: Nk // 4],
                           min(n - m, cut - 1), P, mask_on(m, dev), probes)
    bs0 = v0()
    nz0 = torch.nonzero(bs0).flatten()
    print(f"V0 shipped      : {fmt_ms(time_ms(v0), n)}  "
          f"cand_blocks={nz0.numel()} {label}", flush=True)
    bad = 0
    for name, kind, R in (("V1 narrow-roll ", "v1", 128),
                          ("V2 lite-epilog ", "v2", 128),
                          ("V3 lite R=256  ", "v2", 256),
                          ("V4 lite R=512  ", "v2", 512)):
        vf = functools.partial(run_variant, kind, words, n, P, m, probes, R)
        bs = vf()[1]
        nz = torch.nonzero(bs).flatten()
        same = ("bit-exact" if torch.equal(bs, bs0)
                else "same-set" if torch.equal(nz, nz0) else "MISMATCH")
        bad += same == "MISMATCH"
        print(f"{name}: {fmt_ms(time_ms(vf), n)}  cand_blocks={nz.numel()}  "
              f"[{same}] {label}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
