"""Shift-AND prefix automaton: KMP's scan kernel (counterpart of the JAX
package's ``kernels/shift_and.py``).

The automaton ``D = ((D << 1) | 1) & B[c]`` tracks in bit j of D whether
``pattern[:j+1]`` ends at the current byte, so a match ends where bit m-1
is set.  ``B[c]`` has bit j set when ``pattern[j] == c``; one 32-bit word
holds 32 pattern bytes, and K = ceil(m/32) words with a carry between them
hold up to ``MAX_SHIFT_AND_PATTERN`` bytes.

Two wrappers over ``csrc/shift_and.cu``: K4 ``kmp_bsums``, the automaton's
match starts counted per 512-byte block, and K10a ``kmp_nib``, the same
counts plus the nibble plane of the starts (``emission='nib'``).  Each
also runs K9, the reference's opt-in automaton variants: the composed-4
step (``STEP_PATH = "composed"``) and the compare-B lookup (``pat_key``,
one state word).  Every variant runs on ``kmp_warp_kernel`` (a warp per
block, the automaton carried across each warp's span of blocks), the step
and the table's source its template policies.  Each has a plain
PyTorch version in this module and launch counters (``.launches`` for
every launch, ``.k9_launches`` per K9 variant).  A wrapper runs the plain
version for a CPU tensor and launches the kernel for a CUDA tensor; there
is no other route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import naive as naive_ops
from ..utils import cuda_build
from ..utils.cuda_build import I64, INT, PTR
from . import swar

MAX_STATE_WORDS = 8
MAX_SHIFT_AND_PATTERN = 32 * MAX_STATE_WORDS  # 256, BASELINE config 3's range

# Automaton step of the kernels, as the reference's module global of the
# same name: "auto" and "perbyte" run one step per byte, "composed" four
# steps per text word (m >= 5; shorter patterns run per byte).  Setting it
# is how ``match`` reaches the composed step.
STEP_PATH = "auto"
STEP_PATHS = ("auto", "perbyte", "composed")
COMPOSED_MIN_M = 5  # the composed step reads bits m-5..m-1 of the state


def shift_and_supported(m: int) -> bool:
    return 1 <= m <= MAX_SHIFT_AND_PATTERN


def state_words(m: int) -> int:
    """K = ceil(m/32) state words of the automaton for m pattern bytes."""
    return max(1, -(-m // 32))


def b_table(pattern: np.ndarray) -> np.ndarray:
    """int32[K, 256]: bit j of B[k, c] is set when pattern[32k + j] == c."""
    pat = np.asarray(pattern, dtype=np.uint8)
    B = np.zeros((state_words(len(pat)), 256), dtype=np.uint32)
    for j, c in enumerate(pat):
        B[j // 32, c] |= np.uint32(1) << np.uint32(j % 32)
    return B.view(np.int32)


def b_table_from_halves(halves: np.ndarray) -> np.ndarray:
    """The reference's lane-replicated int32[K, 2, 8, 128] B-table halves
    (bytes < 128, then >= 128, each repeated over 8 sublanes) as the port's
    int32[K, 256] table."""
    halves = np.asarray(halves)
    return np.ascontiguousarray(halves[:, :, 0, :].reshape(halves.shape[0], 256))


def kernel_region(N: int, m: int, chunk_bytes: int) -> tuple[int, int]:
    """(Nk, cut) for the automaton and rolling-hash kernels, whose tile is
    the reference's 128 * chunk_bytes (2 MiB at the default; the SWAR
    kernels clamp the chunk to 4096 bytes, these do not)."""
    return swar.tile_region(N, m, 128 * chunk_bytes)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_ARGS = [PTR, I64, I64, PTR, INT, INT, PTR, PTR, INT, INT, PTR]
_SIGNATURES = {"tpm_kmp_bsums": _ARGS, "tpm_kmp_nib": _ARGS + [PTR]}


def check_region(words: torch.Tensor) -> None:
    """The scan kernels' region: contiguous int32 words, whole 512-byte
    blocks, on the CPU or a CUDA device (there 16-byte aligned)."""
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if words.dim() != 1 or words.numel() % swar.BLOCK_WORDS:
        raise ValueError(
            f"words must be 1-D with a multiple of {swar.BLOCK_WORDS} "
            f"elements, got shape {tuple(words.shape)}"
        )
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")
    if words.device.type == "cuda" and words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary")


def _check(words: torch.Tensor, bt: torch.Tensor, m: int,
           pat_key: bytes | None = None) -> tuple[bool, bool]:
    """Validate a wrapper's arguments; returns the K9 variant it runs,
    (composed step, compare-B lookup)."""
    check_region(words)
    if not shift_and_supported(m):
        raise ValueError(f"m must be in 1..{MAX_SHIFT_AND_PATTERN}, got {m}")
    if bt.dtype != torch.int32 or not bt.is_contiguous():
        raise TypeError("bt must be a contiguous int32 tensor")
    if tuple(bt.shape) != (state_words(m), 256):
        raise ValueError(
            f"bt must be [{state_words(m)}, 256] for m={m}, got "
            f"{tuple(bt.shape)}"
        )
    if bt.device != words.device:
        raise ValueError(f"bt is on {bt.device}, words on {words.device}")
    if STEP_PATH not in STEP_PATHS:
        raise ValueError(
            f"STEP_PATH must be one of {STEP_PATHS}, got {STEP_PATH!r}")
    if pat_key is not None and len(pat_key) != m:
        raise ValueError(
            f"pat_key must hold the m={m} pattern bytes, got {len(pat_key)}")
    return (STEP_PATH == "composed" and m >= COMPOSED_MIN_M,
            pat_key is not None and state_words(m) == 1)


def compare_tables(pat_key: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Compare-B's inputs: the pattern's distinct bytes (first-occurrence
    order) and, for each, its B mask (bit j set when pat_key[j] is that
    byte), both uint32 viewed as int32."""
    masks: dict[int, int] = {}
    for j, c in enumerate(pat_key):
        masks[c] = masks.get(c, 0) | (1 << j)
    return (np.array(list(masks), np.uint32).view(np.int32),
            np.array(list(masks.values()), np.uint32).view(np.int32))


def pattern_from_table(bt: torch.Tensor, m: int) -> torch.Tensor:
    """uint8[m] pattern whose ``b_table`` is ``bt``: the byte whose B entry
    has bit j set, for each j."""
    j = torch.arange(m, device=bt.device)
    bits = (bt[j // 32].to(torch.int64) >> (j % 32)[:, None]) & 1
    return bits.argmax(1).to(torch.uint8)


def _starts(words, n_lim: int, bt, m: int) -> torch.Tensor:
    """bool[4 Nw]: the starts s <= n_lim where the m bytes that ``bt``
    encodes match.  The automaton's hits are exactly these, so the plain
    versions find them by shifted compare instead of running it."""
    text = words.view(torch.uint8)
    hit = naive_ops.naive_start_mask(text, pattern_from_table(bt, m))
    return hit & (torch.arange(text.numel(), device=text.device) <= n_lim)


def kmp_bsums_plain(words, n_lim: int, bt, m: int) -> torch.Tensor:
    """Plain PyTorch version of ``kmp_bsums`` (same contract)."""
    hit = _starts(words, n_lim, bt, m)
    return hit.view(-1, swar.BLOCK_BYTES).sum(1, dtype=torch.int32)


def _launch(wrapper, fn: str, words, n_lim: int, bt, m: int,
            variant: tuple[bool, bool], pat_key, *out: torch.Tensor):
    """Run C entry ``fn`` (K4/K10a, or K9 when ``variant`` asks for the
    composed step or compare-B) over the region, counting the launch on
    ``wrapper``; returns int32[Nw/128] block sums."""
    composed, compare_b = variant
    cmp = [torch.empty(0, dtype=torch.int32, device=words.device)] * 2
    if compare_b:
        cmp = [torch.from_numpy(a).to(words.device)
               for a in compare_tables(pat_key)]
    bs = torch.empty(words.numel() // swar.BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    cuda_build.launch(cuda_build.load("shift_and", _SIGNATURES), fn,
                      words.device, words.data_ptr(), 4 * words.numel(),
                      int(n_lim), bt.data_ptr(), bt.shape[0], m,
                      cmp[0].data_ptr(), cmp[1].data_ptr(), cmp[0].numel(),
                      int(composed), *(t.data_ptr() for t in out),
                      bs.data_ptr())
    wrapper.launches += 1
    for name, on in (("composed", composed), ("compare_b", compare_b)):
        wrapper.k9_launches[name] += on
    return bs


def kmp_bsums(words: torch.Tensor, n_lim: int, bt: torch.Tensor, m: int,
              pat_key: bytes | None = None) -> torch.Tensor:
    """K4, the Shift-AND scan over the kernel region, or K9 for the
    reference's opt-in step and lookup.

    ``words``: int32[Nw] region words (Nw a multiple of 128); ``n_lim``: the
    largest start counted (the caller's clamp, min(n, Nk) - m); ``bt``:
    int32[K, 256] from ``b_table`` of the m pattern bytes the automaton
    runs.  Returns int32[Nw/128]: per 512-byte block the starts s <= n_lim
    where those m bytes match.  The module global ``STEP_PATH`` picks the
    automaton step; "composed" runs K9's composed-4 step for m >= 5.
    ``pat_key``: the m pattern bytes that
    ``bt`` encodes; given, and at K = 1, B comes from compares against them
    (K9's compare-B) instead of the table; at K > 1 it has no effect, as in
    the reference.  Every variant computes the same function, so
    ``kmp_bsums_plain`` is the plain version of all of them.  Replaces the
    reference's ``_kernel`` with ``emit='bsums'`` (``kmp_bsums``);
    csrc/shift_and.cu notes what bounds it."""
    variant = _check(words, bt, m, pat_key)
    if words.device.type == "cpu":
        return kmp_bsums_plain(words, n_lim, bt, m)
    return _launch(kmp_bsums, "tpm_kmp_bsums", words, n_lim, bt, m, variant,
                   pat_key)


kmp_bsums.launches = 0
kmp_bsums.k9_launches = {"composed": 0, "compare_b": 0}


def kmp_nib_plain(words, n_lim: int, bt, m: int):
    """Plain PyTorch version of ``kmp_nib`` (same contract)."""
    hit = _starts(words, n_lim, bt, m)
    return (swar.pack_nibbles(hit),
            hit.view(-1, swar.BLOCK_BYTES).sum(1, dtype=torch.int32))


def kmp_nib(words: torch.Tensor, n_lim: int, bt: torch.Tensor, m: int,
            pat_key: bytes | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K10a, the Shift-AND scan with the nibble plane (KMP with
    ``emission='nib'``), or K9 for the reference's opt-in step and lookup:
    ``kmp_bsums``'s arguments, K = ceil(m/32) state words of the whole
    pattern.  Returns (nib int32[Nw], bs int32[Nw/128]): bit a of nib[w] =
    start at byte 4w + a <= n_lim, bs = ``kmp_bsums``.  ``STEP_PATH`` and
    ``pat_key`` as for ``kmp_bsums``; ``kmp_nib_plain`` is the plain
    version of every variant.  Replaces the reference's ``_kernel`` with
    ``emit='nib'`` and the end-to-start shift of its host wrapper
    ``kmp_nib``, whose nibbles carry no validity (applied downstream there,
    in the kernel here)."""
    variant = _check(words, bt, m, pat_key)
    if words.device.type == "cpu":
        return kmp_nib_plain(words, n_lim, bt, m)
    nib = torch.empty_like(words)
    bs = _launch(kmp_nib, "tpm_kmp_nib", words, n_lim, bt, m, variant,
                 pat_key, nib)
    return nib, bs


kmp_nib.launches = 0
kmp_nib.k9_launches = {"composed": 0, "compare_b": 0}
