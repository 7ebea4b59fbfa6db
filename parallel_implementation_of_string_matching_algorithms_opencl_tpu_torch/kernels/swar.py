"""SWAR matching kernels: host-side pattern words plus the two CUDA kernels.

Counterpart of the JAX package's ``kernels/swar.py``.  Text is processed as
little-endian int32 words (4 bytes each).  For each alignment a in 0..3, a
match starting at byte 4w + a satisfies

    AND_k  (word[w + k] & M[a, k]) == P[a, k]          k in [0, nw)

where P[a]/M[a] are the pattern placed at byte offset a in a zeroed word
buffer and its 0xFF byte-occupancy mask.

Two kernels (``csrc/swar.cu``), each with a plain PyTorch version in this
module and a launch counter (``<wrapper>.launches``):

- ``screen_cand_bsums`` (K1): the Boyer-Moore probe screen, candidate words
  counted per 512-byte block;
- ``naive_nib`` (K2): the exact verify of every start as a nibble plane
  plus per-block popcounts.

A wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; there is no other route.  Both emit block sums in byte
order and read words past the end of their input as 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_build

HALO_WORDS = 128          # the reference's 512-byte chunk halo
MAX_PATTERN = HALO_WORDS * 4 - 3  # 509: kernel-path bound shared with it
BLOCK_WORDS = 128         # words per 512-byte block sum


def swar_supported(m: int) -> bool:
    """Kernel path eligibility (longer patterns take the plain mask route,
    as in the reference)."""
    return 1 <= m <= MAX_PATTERN


def kernel_region(N: int, m: int, chunk_bytes: int) -> tuple[int, int]:
    """(Nk, cut) for a padded text of N bytes: the kernels cover the first
    Nk bytes (N floored to the reference's 128 * min(chunk_bytes, 4096)
    tile), and positions from ``cut = Nk - (m-1)`` on belong to the tail.
    Nk is 0 when the text is shorter than one tile."""
    tile = 128 * min(chunk_bytes, 4096)
    Nk = (N // tile) * tile
    return Nk, (Nk - (m - 1) if Nk else 0)


def mask_words(m: int) -> np.ndarray:
    """int32[4, nw] byte-occupancy masks — a function of m alone."""
    nw = (3 + m + 3) // 4
    M = np.zeros((4, nw), dtype=np.uint32)
    for a in range(4):
        msk = np.zeros(nw * 4, dtype=np.uint8)
        msk[a : a + m] = 0xFF
        M[a] = msk.view(np.uint32)
    return M.view(np.int32)


def pattern_words(pattern: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P, M) int32[4, nw]: word/mask variants for byte alignments 0..3.

    nw = number of words the pattern can touch in the worst alignment.
    Little-endian packing, matching the uint8 -> int32 view of the text.
    """
    pat = np.asarray(pattern, dtype=np.uint8)
    m = len(pat)
    nw = (3 + m + 3) // 4
    P = np.zeros((4, nw), dtype=np.uint32)
    for a in range(4):
        buf = np.zeros(nw * 4, dtype=np.uint8)
        buf[a : a + m] = pat
        P[a] = buf.view(np.uint32)
    return P.view(np.int32), mask_words(m)


def probe_indices(M: np.ndarray) -> tuple:
    """Positional probes (bm_probes='static'): per alignment the first and
    last interior (all-ones-mask) words, or masked word 0 for tiny
    patterns."""
    out = []
    for a in range(4):
        full = np.nonzero(M[a] == -1)[0]
        if len(full) >= 2:
            out.append((int(full[0]), int(full[-1])))
        elif len(full) == 1:
            out.append((int(full[0]),))
        else:
            out.append((0,))
    return tuple(out)


def probe_table(pattern: np.ndarray, use_gs: bool = False) -> np.ndarray:
    """int32[4, 2] bad-character-scored probe word indices per alignment,
    identical to the reference's ``probe_table`` (single=False).

    Each full word is scored by the summed bad-character shift of its four
    bytes; ``use_gs`` adds the summed good-suffix shifts.  Words whose
    4-byte value recurs as another 4-gram of the pattern are penalized.
    The best word wins; its partner is the farthest other word, score as
    tiebreak."""
    pat = np.asarray(pattern, dtype=np.uint8)
    m = len(pat)
    Mnp = mask_words(m)
    last = {}
    for j, c in enumerate(pat.tolist()):
        last[c] = j
    bc = {c: m - 1 - j for c, j in last.items()}
    gs = None
    if use_gs:
        from ..ops import tables as _tables

        gs = _tables.bm_good_suffix(pat)
    grams = {}
    for j in range(max(0, m - 3)):
        g = bytes(pat[j : j + 4])
        grams[g] = grams.get(g, 0) + 1
    out = np.zeros((4, 2), np.int32)
    for a in range(4):
        full = np.nonzero(Mnp[a] == -1)[0]
        if len(full) == 0:
            continue  # masked word 0 (tiny pattern) — the kernel masks it
        scores = []
        for k in full.tolist():
            b = bytes(pat[4 * k - a : 4 * k - a + 4])
            s = sum(bc[c] for c in b)
            if gs is not None:
                lo = 4 * k - a
                s += sum(int(gs[j + 1]) for j in range(lo, lo + 4))
            if grams.get(b, 0) > 1:
                s -= 16 * m  # repeated 4-gram: weak probe
            scores.append((s, k))
        scores.sort(reverse=True)
        best = scores[0][1]
        if len(scores) == 1:
            out[a] = (best, best)
        else:
            k2 = max(
                ((abs(k - best), s), k) for s, k in scores if k != best
            )[1]
            out[a] = (min(best, k2), max(best, k2))
    return out


def static_probes_from_table(pr: np.ndarray) -> tuple:
    """``probe_table`` output -> per-alignment probe tuples (dedup'd
    pairs), the form ``screen_cand_bsums`` takes."""
    pr = np.asarray(pr)
    return tuple(
        tuple(sorted({int(pr[a, 0]), int(pr[a, 1])})) for a in range(4)
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "tpm_screen_cand_bsums": [_PTR, _I64, _I64, _PTR, _PTR, _INT]
    + [_INT] * 8 + [_PTR, _PTR],
    "tpm_naive_nib": [_PTR, _I64, _I64, _PTR, _PTR, _INT, _PTR, _PTR, _PTR],
}


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("swar")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
    lib.tpm_error_string.argtypes = [_INT]
    lib.tpm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` on ``device``'s current stream (appended as the
    last argument); raise on a refused launch."""
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn} failed: CUDA error {err} "
            f"({lib.tpm_error_string(err).decode()})"
        )


def _check(words: torch.Tensor, P: torch.Tensor, M: torch.Tensor) -> None:
    for name, t in (("words", words), ("P", P), ("M", M)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
    if words.dim() != 1 or words.numel() % BLOCK_WORDS:
        raise ValueError(
            f"words must be 1-D with a multiple of {BLOCK_WORDS} elements, "
            f"got shape {tuple(words.shape)}"
        )
    if P.dim() != 2 or P.shape[0] != 4 or P.shape != M.shape:
        raise ValueError(
            f"P and M must both be [4, nw], got {tuple(P.shape)} and "
            f"{tuple(M.shape)}"
        )
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


def _shifted(words: torch.Tensor, nw: int):
    """Words followed by nw zero words: ``ext[k : k + n]`` is word i + k
    for every i, with 0 past the end (the kernels' out-of-range read)."""
    return torch.cat([words, words.new_zeros(nw)])


def screen_cand_bsums_plain(words, n_lim: int, P, M, probes) -> torch.Tensor:
    """Plain PyTorch version of ``screen_cand_bsums`` (same contract)."""
    n = words.numel()
    ext = _shifted(words, P.shape[1])
    cand = torch.zeros(n, dtype=torch.bool, device=words.device)
    for a, ks in enumerate(probes):
        acc = None
        for k in ks:
            eq = (ext[k : k + n] & M[a, k]) == P[a, k]
            acc = eq if acc is None else acc & eq
        cand |= acc
    pos = 4 * torch.arange(n, dtype=torch.int64, device=words.device)
    cand &= pos <= n_lim
    return cand.view(-1, BLOCK_WORDS).sum(1, dtype=torch.int32)


def screen_cand_bsums(words: torch.Tensor, n_lim: int, P: torch.Tensor,
                      M: torch.Tensor, probes) -> torch.Tensor:
    """K1, the Boyer-Moore probe screen over the kernel region.

    ``words``: int32[Nw] region words (Nw a multiple of 128); ``n_lim``:
    the largest valid start byte (candidates are clamped per word,
    4w <= n_lim); ``P``/``M``: int32[4, nw] pattern words; ``probes``: per
    alignment one or two word indices.  Returns int32[Nw/128]: candidate
    words per 512-byte block, a superset of the blocks holding matches.
    Replaces the reference's ``_screen_cand_kernel`` (csrc/swar.cu notes
    what bounds it)."""
    _check(words, P, M)
    nw = P.shape[1]
    if len(probes) != 4 or any(
        not 1 <= len(ks) <= 2 or not all(0 <= k < nw for k in ks)
        for ks in probes
    ):
        raise ValueError(f"bad probe layout {probes!r} for nw={nw}")
    if words.device.type == "cpu":
        return screen_cand_bsums_plain(words, n_lim, P, M, probes)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    ks = [int(k) for pair in probes for k in (pair[0], pair[-1])]
    _launch("tpm_screen_cand_bsums", words.device, words.data_ptr(),
            words.numel(), int(n_lim), P.data_ptr(), M.data_ptr(), nw, *ks,
            bs.data_ptr())
    screen_cand_bsums.launches += 1
    return bs


screen_cand_bsums.launches = 0


def popcount4(nib: torch.Tensor) -> torch.Tensor:
    """Set bits among the low four of each int32 nibble word."""
    return (nib & 1) + ((nib >> 1) & 1) + ((nib >> 2) & 1) + ((nib >> 3) & 1)


def naive_nib_plain(words, n_lim: int, P, M):
    """Plain PyTorch version of ``naive_nib`` (same contract)."""
    n = words.numel()
    ext = _shifted(words, P.shape[1])
    nib = torch.zeros(n, dtype=torch.int32, device=words.device)
    for a in range(4):
        acc = torch.ones(n, dtype=torch.bool, device=words.device)
        for k in range(P.shape[1]):
            # Words the pattern does not touch have M = P = 0: always true.
            acc &= (ext[k : k + n] & M[a, k]) == P[a, k]
        nib |= acc.to(torch.int32) << a
    pos = 4 * torch.arange(n, dtype=torch.int64, device=words.device)
    keep = (n_lim - pos + 1).clamp(0, 4)
    nib &= ((1 << keep) - 1).to(torch.int32)
    return nib, popcount4(nib).view(-1, BLOCK_WORDS).sum(1, dtype=torch.int32)


def naive_nib(words: torch.Tensor, n_lim: int, P: torch.Tensor,
              M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2, the exact verify of every start over the kernel region.

    Returns (nib int32[Nw], bs int32[Nw/128]): bit a of nib[w] = match at
    byte 4w + a, kept only where 4w + a <= n_lim (validity per alignment);
    bs = exact matches per 512-byte block.  Replaces the reference's
    ``_naive_kernel`` (naive_nib with emit_nib=True)."""
    _check(words, P, M)
    if words.device.type == "cpu":
        return naive_nib_plain(words, n_lim, P, M)
    nib = torch.empty_like(words)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    _launch("tpm_naive_nib", words.device, words.data_ptr(), words.numel(),
            int(n_lim), P.data_ptr(), M.data_ptr(), P.shape[1],
            nib.data_ptr(), bs.data_ptr())
    naive_nib.launches += 1
    return nib, bs


naive_nib.launches = 0
