"""Rolling-hash Rabin-Karp screen kernel (counterpart of the JAX package's
``kernels/rk_roll.py``).

The window hash ``H = sum_j x[s+j] * B^(m-1-j) mod 2**32``
(``ops/tables.rk_hash``), and windows whose hash equals a target are
candidate starts; the caller verifies them.

Four kernels, one design (``csrc/rk_roll.cu`` ``rk_warp_kernel``: a warp
per 512-byte block on prefix hashes, ``H = P(s+m) - B^m * P(s)``), which
differ only in what a block emits: K5 ``rk_candidate_bsums`` counts
candidate starts per block; K10b ``rk_candidate_nib`` writes K5's counts
and the candidate nibble plane (``emission='nib'``); K6
``rk_candidate_pmask`` sets, per block, bit p when a start hashes to
pattern p (the multi-pattern screen, k <= 31); K10c ``rk_candidate_bmask``
sets, per block, bit g when a start in its 32-byte group g hashes to any
target (``multi_gather='groups'``).  Each has a plain PyTorch version in
this module and a launch counter (``.launches``).  A wrapper runs the plain version for a CPU
tensor and launches the kernel for a CUDA tensor; there is no other route.
The region geometry is the Shift-AND kernel's
(``shift_and.kernel_region``).
"""

from __future__ import annotations

import torch

from ..ops import rabin_karp as rk_ops
from ..ops import tables
from ..utils import cuda_build
from ..utils.cuda_build import I64, INT, PTR, U32
from . import shift_and, swar

MAX_RK_PATTERN = 509  # the reference's per-sub-chunk halo bound
MAX_PMASK_PATTERNS = 31  # one bit per pattern, the sign bit unused
GROUP_BYTES = 32  # K10c: one occupancy bit per 32-byte group, 16 per block


def rk_roll_supported(m: int) -> bool:
    """Kernel path eligibility (m = 1 and longer patterns take the plain
    mask route, as in the reference)."""
    return 2 <= m <= MAX_RK_PATTERN


def rk_params(m: int, base: int) -> tuple[int, int]:
    """(B, B^m), both wrapped mod 2**32; B must be odd."""
    B = int(base) & rk_ops.MASK32
    if B % 2 == 0:
        raise ValueError("RK base must be odd (invertible mod 2**32)")
    return B, pow(B, m, 1 << 32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_ARGS = [PTR, I64, I64, INT, U32, U32, PTR, INT, PTR]
_SIGNATURES = {"tpm_rk_candidate_bsums": _ARGS, "tpm_rk_candidate_pmask": _ARGS,
               "tpm_rk_candidate_bmask": _ARGS,
               "tpm_rk_candidate_nib": _ARGS + [PTR]}


def _check(words: torch.Tensor, targets: torch.Tensor, m: int,
           base: int) -> None:
    shift_and.check_region(words)
    if not 1 <= m <= MAX_RK_PATTERN:
        raise ValueError(f"m must be in 1..{MAX_RK_PATTERN}, got {m}")
    if targets.dtype != torch.int64:
        raise TypeError(f"targets must be int64, got {targets.dtype}")
    if targets.dim() != 1 or targets.numel() == 0:
        raise ValueError(
            f"targets must be 1-D and non-empty, got {tuple(targets.shape)}")
    if targets.device != words.device:
        raise ValueError(
            f"targets are on {targets.device}, words on {words.device}")
    rk_params(m, base)


def _window_hashes(words, n_lim: int, m: int, base: int):
    """(int64 window hashes of the region, bool[N] positions <= n_lim)."""
    text = words.view(torch.uint8)
    powers = torch.from_numpy(
        tables.rk_constants(m, base)["powers"].astype("int64")).to(text.device)
    h = rk_ops.rk_window_hashes(text, powers)
    return h, torch.arange(text.numel(), device=text.device) <= n_lim


def _candidates(words, n_lim: int, targets, m: int, base: int):
    """bool[4 Nw]: the starts s <= n_lim whose window hash, by direct sum
    (``ops/rabin_karp.rk_window_hashes``), equals any target."""
    h, valid = _window_hashes(words, n_lim, m, base)
    cand = torch.zeros_like(h, dtype=torch.bool)
    for p in range(targets.numel()):
        cand |= h == targets[p]
    return cand & valid


def rk_candidate_bsums_plain(words, n_lim: int, targets, m: int,
                             base: int) -> torch.Tensor:
    """Plain PyTorch version of ``rk_candidate_bsums`` (same contract)."""
    cand = _candidates(words, n_lim, targets, m, base)
    return cand.view(-1, swar.BLOCK_BYTES).sum(1, dtype=torch.int32)


def rk_candidate_pmask_plain(words, n_lim: int, targets, m: int,
                             base: int) -> torch.Tensor:
    """Plain PyTorch version of ``rk_candidate_pmask`` (same contract)."""
    h, valid = _window_hashes(words, n_lim, m, base)
    pm = torch.zeros(h.numel() // swar.BLOCK_BYTES, dtype=torch.int32,
                     device=h.device)
    for p in range(targets.numel()):
        hit = ((h == targets[p]) & valid).view(-1, swar.BLOCK_BYTES).any(1)
        pm |= hit.to(torch.int32) << p
    return pm


def _launch(fn: str, words, n_lim: int, targets, m: int, base: int,
            *out: torch.Tensor):
    """Run C entry ``fn`` (K5, K6, K10c, or K10b with the nibble plane ``out``)
    over the region; int32[Nw/128]."""
    B, Bm = rk_params(m, base)
    # uint32 bits as int32: values >= 2**31 move down by 2**32.
    tgt = (targets - ((targets >> 31) << 32)).to(torch.int32).contiguous()
    bs = torch.empty(words.numel() // swar.BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    cuda_build.launch(cuda_build.load("rk_roll", _SIGNATURES), fn,
                      words.device, words.data_ptr(), 4 * words.numel(),
                      int(n_lim), m, B, Bm, tgt.data_ptr(), tgt.numel(),
                      *(t.data_ptr() for t in out), bs.data_ptr())
    return bs


def rk_candidate_bsums(words: torch.Tensor, n_lim: int, targets: torch.Tensor,
                       m: int, base: int) -> torch.Tensor:
    """K5, the rolling-hash screen over the kernel region.

    ``words``: int32[Nw] region words (Nw a multiple of 128); ``n_lim``: the
    largest start counted (min(n, Nk) - m); ``targets``: int64[k] uint32
    hash values (``ops/tables.rk_hash`` with this ``base``).  Returns
    int32[Nw/128]: per 512-byte block the starts s <= n_lim whose window
    hash equals any target, a superset of the matches.  Replaces the
    reference's ``_kernel`` with ``emit='bsums'`` (``rk_candidate_bsums``);
    csrc/rk_roll.cu notes what bounds it."""
    _check(words, targets, m, base)
    if words.device.type == "cpu":
        return rk_candidate_bsums_plain(words, n_lim, targets, m, base)
    bs = _launch("tpm_rk_candidate_bsums", words, n_lim, targets, m, base)
    rk_candidate_bsums.launches += 1
    return bs


def rk_candidate_pmask(words: torch.Tensor, n_lim: int, targets: torch.Tensor,
                       m: int, base: int) -> torch.Tensor:
    """K6, the multi-pattern screen: ``rk_candidate_bsums``'s arguments
    with 1 <= k <= 31 targets.  Returns int32[Nw/128] in which bit p of
    block b is set exactly when some start s in b with s <= n_lim hashes to
    ``targets[p]``: per pattern, a superset of the block's matches.
    Replaces the reference's ``_kernel`` with ``emit='pmask'`` and its
    fold ``shift_and._end_to_start_pmask``, whose bits are a superset of
    these (csrc/rk_roll.cu)."""
    _check(words, targets, m, base)
    if targets.numel() > MAX_PMASK_PATTERNS:
        raise ValueError(
            f"at most {MAX_PMASK_PATTERNS} targets fit a pattern mask, got "
            f"{targets.numel()}")
    if words.device.type == "cpu":
        return rk_candidate_pmask_plain(words, n_lim, targets, m, base)
    pm = _launch("tpm_rk_candidate_pmask", words, n_lim, targets, m, base)
    rk_candidate_pmask.launches += 1
    return pm


def rk_candidate_nib_plain(words, n_lim: int, targets, m: int, base: int):
    """Plain PyTorch version of ``rk_candidate_nib`` (same contract)."""
    cand = _candidates(words, n_lim, targets, m, base)
    return (swar.pack_nibbles(cand),
            cand.view(-1, swar.BLOCK_BYTES).sum(1, dtype=torch.int32))


def rk_candidate_nib(words: torch.Tensor, n_lim: int, targets: torch.Tensor,
                     m: int, base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K10b, the rolling-hash screen with the candidate nibble plane
    (Rabin-Karp and multi-pattern with ``emission='nib'``):
    ``rk_candidate_bsums``'s arguments, any k >= 1 targets.  Returns
    (nib int32[Nw], bs int32[Nw/128]): bit a of nib[w] = the window at
    byte 4w + a <= n_lim hashes to some target, bs = ``rk_candidate_bsums``.
    The bits are candidates: the caller verifies them.  Replaces the
    reference's ``_kernel`` with ``emit='nib'`` and the end-to-start shift
    of its host wrapper ``rk_candidate_nib``."""
    _check(words, targets, m, base)
    if words.device.type == "cpu":
        return rk_candidate_nib_plain(words, n_lim, targets, m, base)
    nib = torch.empty_like(words)
    bs = _launch("tpm_rk_candidate_nib", words, n_lim, targets, m, base, nib)
    rk_candidate_nib.launches += 1
    return nib, bs


def rk_candidate_bmask_plain(words, n_lim: int, targets, m: int,
                             base: int) -> torch.Tensor:
    """Plain PyTorch version of ``rk_candidate_bmask`` (same contract)."""
    cand = _candidates(words, n_lim, targets, m, base)
    groups = cand.view(-1, swar.BLOCK_BYTES // GROUP_BYTES, GROUP_BYTES).any(2)
    weights = 1 << torch.arange(groups.shape[1], device=groups.device)
    return (groups.to(torch.int64) * weights).sum(1).to(torch.int32)


def rk_candidate_bmask(words: torch.Tensor, n_lim: int, targets: torch.Tensor,
                       m: int, base: int) -> torch.Tensor:
    """K10c, the group-occupancy screen (``multi_gather='groups'``):
    ``rk_candidate_bsums``'s arguments, any k >= 1 targets (the mask is per
    group, not per pattern).  Returns int32[Nw/128] in which bit g (0..15)
    of block b is set exactly when some start s <= n_lim in bytes
    [512b + 32g, 512b + 32g + 32) hashes to any target: nonzero exactly
    where ``rk_candidate_bsums`` is.  Replaces the reference's ``_kernel``
    with ``emit='bmask'`` and its fold ``shift_and._end_to_start_bmask``."""
    _check(words, targets, m, base)
    if words.device.type == "cpu":
        return rk_candidate_bmask_plain(words, n_lim, targets, m, base)
    bm = _launch("tpm_rk_candidate_bmask", words, n_lim, targets, m, base)
    rk_candidate_bmask.launches += 1
    return bm


rk_candidate_bsums.launches = 0
rk_candidate_pmask.launches = 0
rk_candidate_nib.launches = 0
rk_candidate_bmask.launches = 0
