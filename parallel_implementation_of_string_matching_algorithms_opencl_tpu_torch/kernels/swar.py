"""SWAR matching kernels: host-side pattern words plus three CUDA kernels.

Counterpart of the JAX package's ``kernels/swar.py``.  Text is processed as
little-endian int32 words (4 bytes each).  For each alignment a in 0..3, a
match starting at byte 4w + a satisfies

    AND_k  (word[w + k] & M[a, k]) == P[a, k]          k in [0, nw)

where P[a]/M[a] are the pattern placed at byte offset a in a zeroed word
buffer and its 0xFF byte-occupancy mask.

Seven kernel wrappers (``csrc/swar.cu``), each with a plain PyTorch version
in this module and a launch counter (``<wrapper>.launches``):

- ``screen_cand_bsums`` (K1): the Boyer-Moore probe screen, candidate words
  counted per 512-byte block;
- ``naive_nib`` (K2): the exact verify of every start as a nibble plane
  plus per-block popcounts;
- ``naive_bsums`` (K3): the same exact verify emitting only the per-block
  match counts (the naive matcher's scan);
- ``screened_nib`` and ``screened_bsums`` (K7, and K8 with the
  ``bm_probes='table_dyn'`` probes): the probe screen, then the exact
  verify of the words with a probe hit, with and without the nibble plane.
  Their results equal ``naive_nib``'s and ``naive_bsums``'s;
- ``screen_cand_nibsums`` (K11a, K11c): the probe screen with a count of
  (word, alignment) candidates per block and in total, the screen of the
  ``exp/`` prototypes;
- ``gather_verify`` (K11d): ``naive_nib``'s exact verify of listed 4 KiB
  groups only, their nibble rows, per-row counts and total;
- ``decode_blocks``: no scan, the extraction after one: from a scan's block
  flags to every pattern's exact count and first ``capacity`` offsets over
  all valid starts, the tail past the scan's cut included, in three
  launches.

A wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; there is no other route.  All scans emit block sums in
byte order and read words past the end of their input as 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.cuda_build import I64, INT, PTR
from ..utils.profiling import span

HALO_WORDS = 128          # the reference's 512-byte chunk halo
MAX_PATTERN = HALO_WORDS * 4 - 3  # 509: kernel-path bound shared with it
BLOCK_WORDS = 128         # words per 512-byte block sum
BLOCK_BYTES = 4 * BLOCK_WORDS
GROUP_WORDS = 8 * BLOCK_WORDS  # words per 4 KiB group of gather_verify
SEGMENT_BLOCKS = 32  # blocks per warp of decode_blocks: one flag per lane


def swar_supported(m: int) -> bool:
    """Kernel path eligibility (longer patterns take the plain mask route,
    as in the reference)."""
    return 1 <= m <= MAX_PATTERN


def tile_region(N: int, m: int, tile: int) -> tuple[int, int]:
    """(Nk, cut) for a padded text of N bytes and a kernel tile: the kernels
    cover the first Nk bytes (N floored to the tile), and positions from
    ``cut = Nk - (m-1)`` on belong to the tail.  Nk is 0 when the text is
    shorter than one tile."""
    Nk = (N // tile) * tile
    return Nk, (Nk - (m - 1) if Nk else 0)


def kernel_region(N: int, m: int, chunk_bytes: int) -> tuple[int, int]:
    """``tile_region`` for the SWAR kernels (K1-K3), whose tile is the
    reference's 128 * min(chunk_bytes, 4096)."""
    return tile_region(N, m, 128 * min(chunk_bytes, 4096))


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


def probe_table(pattern: np.ndarray, use_gs: bool = False,
                single: bool = False) -> np.ndarray:
    """int32[4, 2] bad-character-scored probe word indices per alignment,
    identical to the reference's ``probe_table``.

    Each full word is scored by the summed bad-character shift of its four
    bytes; ``use_gs`` adds the summed good-suffix shifts.  Words whose
    4-byte value recurs as another 4-gram of the pattern are penalized.
    The best word wins (highest score, then highest index); its partner is
    the farthest other word, score as tiebreak.  ``single``
    (bm_probes='table_gs1') keeps the best word alone, repeated."""
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
        if single or len(scores) == 1:
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

_PROBED = [PTR, I64, I64, PTR, PTR, INT] + [INT] * 8
_SIGNATURES = {
    "tpm_screen_cand_bsums": _PROBED + [PTR],
    "tpm_naive_nib": [PTR, I64, I64, PTR, PTR, INT, PTR, PTR],
    "tpm_naive_bsums": [PTR, I64, I64, PTR, PTR, INT, PTR],
    "tpm_screened_nib": _PROBED + [PTR, PTR],
    "tpm_screened_bsums": _PROBED + [PTR],
    "tpm_screen_cand_nibsums": _PROBED + [PTR, PTR],
    "tpm_gather_verify": [PTR, I64, I64, PTR, I64, PTR, PTR, INT, PTR, PTR, PTR],
    "tpm_decode_blocks": [PTR, I64, PTR, I64, PTR, PTR, INT, INT, INT, INT, I64,
                          I64, I64, PTR, PTR, PTR, PTR, I64],
}


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` of ``csrc/swar.cu`` on ``device``'s current
    stream; raise on a refused launch."""
    cuda_build.launch(cuda_build.load("swar", _SIGNATURES), fn, device, *args)


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


def _check_probes(probes, nw: int) -> list:
    """The kernel's eight probe arguments: per alignment the first and
    last of one or two word indices in [0, nw)."""
    if len(probes) != 4 or any(
        not 1 <= len(ks) <= 2 or not all(0 <= k < nw for k in ks)
        for ks in probes
    ):
        raise ValueError(f"bad probe layout {probes!r} for nw={nw}")
    return [int(k) for pair in probes for k in (pair[0], pair[-1])]


def _probe_hits(words, P, M, probes) -> list:
    """Per alignment a, bool[Nw]: every probe word of a compares equal
    under its mask at word w."""
    n = words.numel()
    ext = _shifted(words, P.shape[1])
    hits = []
    for a, ks in enumerate(probes):
        acc = None
        for k in ks:
            eq = (ext[k : k + n] & M[a, k]) == P[a, k]
            acc = eq if acc is None else acc & eq
        hits.append(acc)
    return hits


def _valid_nibbles(nib, w, n_lim: int):
    """``nib`` with bit a of the nibble of word ``w`` (int64 word indices,
    one per nibble) cleared unless 4w + a <= n_lim."""
    keep = (n_lim - 4 * w + 1).clamp(0, 4)
    return nib & ((1 << keep) - 1).to(torch.int32)


def screen_cand_bsums_plain(words, n_lim: int, P, M, probes) -> torch.Tensor:
    """Plain PyTorch version of ``screen_cand_bsums`` (same contract)."""
    n = words.numel()
    cand = torch.zeros(n, dtype=torch.bool, device=words.device)
    for acc in _probe_hits(words, P, M, probes):
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
    ks = _check_probes(probes, nw)
    if words.device.type == "cpu":
        return screen_cand_bsums_plain(words, n_lim, P, M, probes)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
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
    nib = _valid_nibbles(nib, torch.arange(n, device=words.device), n_lim)
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


def naive_bsums_plain(words, n_lim: int, P, M) -> torch.Tensor:
    """Plain PyTorch version of ``naive_bsums``: ``naive_nib_plain``'s
    block sums."""
    return naive_nib_plain(words, n_lim, P, M)[1]


def naive_bsums(words: torch.Tensor, n_lim: int, P: torch.Tensor,
                M: torch.Tensor) -> torch.Tensor:
    """K3, the naive matcher's scan: the exact verify of ``naive_nib``
    without the nibble plane.  Returns int32[Nw/128], the exact matches per
    512-byte block, each start 4w + a kept only where it is <= n_lim.
    Replaces the reference's ``_naive_sparse_kernel`` (naive_nib with
    emit_nib=False)."""
    _check(words, P, M)
    if words.device.type == "cpu":
        return naive_bsums_plain(words, n_lim, P, M)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    _launch("tpm_naive_bsums", words.device, words.data_ptr(), words.numel(),
            int(n_lim), P.data_ptr(), M.data_ptr(), P.shape[1], bs.data_ptr())
    naive_bsums.launches += 1
    return bs


naive_bsums.launches = 0


def screened_nib_plain(words, n_lim: int, P, M, probes):
    """Plain PyTorch version of ``screened_nib`` (same contract).  The
    probe screen only decides which words the kernel verifies, and a match
    passes its own alignment's probes, so this is ``naive_nib_plain``."""
    _check_probes(probes, P.shape[1])
    return naive_nib_plain(words, n_lim, P, M)


def screened_nib(words: torch.Tensor, n_lim: int, P: torch.Tensor,
                 M: torch.Tensor, probes) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (probes fixed per pattern) and K8 (``bm_probes='table_dyn'``'s
    probes): the Boyer-Moore probe screen, then the exact verify of every
    alignment whose probe words compare equal.

    Arguments as ``screen_cand_bsums``; returns ``naive_nib``'s (nib, bs):
    bit a of nib[w] = match at byte 4w + a <= n_lim, bs = exact matches per
    512-byte block.  Replaces the reference's ``_screened_kernel`` and
    ``_screened_dyn_kernel`` with emit_nib=True (csrc/swar.cu notes what
    bounds it)."""
    _check(words, P, M)
    ks = _check_probes(probes, P.shape[1])
    if words.device.type == "cpu":
        return screened_nib_plain(words, n_lim, P, M, probes)
    nib = torch.empty_like(words)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    _launch("tpm_screened_nib", words.device, words.data_ptr(), words.numel(),
            int(n_lim), P.data_ptr(), M.data_ptr(), P.shape[1], *ks,
            nib.data_ptr(), bs.data_ptr())
    screened_nib.launches += 1
    return nib, bs


screened_nib.launches = 0


def screened_bsums_plain(words, n_lim: int, P, M, probes) -> torch.Tensor:
    """Plain PyTorch version of ``screened_bsums``: ``screened_nib_plain``'s
    block sums."""
    return screened_nib_plain(words, n_lim, P, M, probes)[1]


def screened_bsums(words: torch.Tensor, n_lim: int, P: torch.Tensor,
                   M: torch.Tensor, probes) -> torch.Tensor:
    """K7/K8 without the nibble plane (Boyer-Moore with bm_screen='fused'
    or bm_probes='table_dyn' under sparse emission): int32[Nw/128], the
    exact matches per 512-byte block, equal to ``naive_bsums``.  Replaces
    the reference's ``_screened_kernel`` and ``_screened_dyn_kernel`` with
    emit_nib=False (the nibble plane in VMEM scratch)."""
    _check(words, P, M)
    ks = _check_probes(probes, P.shape[1])
    if words.device.type == "cpu":
        return screened_bsums_plain(words, n_lim, P, M, probes)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    _launch("tpm_screened_bsums", words.device, words.data_ptr(),
            words.numel(), int(n_lim), P.data_ptr(), M.data_ptr(), P.shape[1],
            *ks, bs.data_ptr())
    screened_bsums.launches += 1
    return bs


screened_bsums.launches = 0


def screen_cand_nibsums_plain(words, n_lim: int, P, M, probes):
    """Plain PyTorch version of ``screen_cand_nibsums`` (same contract)."""
    nib = torch.zeros(words.numel(), dtype=torch.int32, device=words.device)
    for a, acc in enumerate(_probe_hits(words, P, M, probes)):
        nib |= acc.to(torch.int32) << a
    nib = _valid_nibbles(nib, torch.arange(words.numel(), device=words.device),
                         n_lim)
    bs = popcount4(nib).view(-1, BLOCK_WORDS).sum(1, dtype=torch.int32)
    return bs, bs.sum(dtype=torch.int32)


def screen_cand_nibsums(words: torch.Tensor, n_lim: int, P: torch.Tensor,
                        M: torch.Tensor, probes) -> tuple[torch.Tensor, torch.Tensor]:
    """K11a/K11c, the probe screen of the ``exp/`` prototypes: K1's probe
    compares with the reference's full epilogue.

    Arguments as ``screen_cand_bsums``.  Returns (bs int32[Nw/128], total
    int32 scalar tensor): bit a of a word's candidate nibble is set when
    alignment a's probe words all compare equal, kept only where
    4w + a <= n_lim (validity per alignment); bs counts the (word,
    alignment) candidates per 512-byte block and total sums them.  Replaces
    ``exp/screen_kernel_opt.py::_v1_kernel`` and
    ``exp/proto_kernels.py::_proto_screen_kernel`` (csrc/swar.cu notes what
    bounds it)."""
    _check(words, P, M)
    ks = _check_probes(probes, P.shape[1])
    if words.device.type == "cpu":
        return screen_cand_nibsums_plain(words, n_lim, P, M, probes)
    bs = torch.empty(words.numel() // BLOCK_WORDS, dtype=torch.int32,
                     device=words.device)
    total = torch.empty((), dtype=torch.int32, device=words.device)
    _launch("tpm_screen_cand_nibsums", words.device, words.data_ptr(),
            words.numel(), int(n_lim), P.data_ptr(), M.data_ptr(), P.shape[1],
            *ks, bs.data_ptr(), total.data_ptr())
    screen_cand_nibsums.launches += 1
    return bs, total


screen_cand_nibsums.launches = 0


def _check_group_ids(words: torch.Tensor, g8: torch.Tensor) -> None:
    if words.numel() % GROUP_WORDS:
        raise ValueError(
            f"words must hold whole {GROUP_WORDS}-word groups, got "
            f"{words.numel()} words"
        )
    if g8.dtype != torch.int32 or g8.dim() != 1 or not g8.is_contiguous():
        raise ValueError(
            f"group ids must be contiguous 1-D int32, got {g8.dtype} "
            f"{tuple(g8.shape)}"
        )
    if g8.device != words.device:
        raise ValueError(f"group ids are on {g8.device}, words on {words.device}")


def gather_verify_plain(words, g8, n_lim: int, P, M):
    """Plain PyTorch version of ``gather_verify`` (same contract)."""
    g = g8.to(torch.int64)
    listed = (g >= 0) & (g < words.numel() // GROUP_WORDS)
    w = g[:, None] * GROUP_WORDS + torch.arange(GROUP_WORDS, device=words.device)
    src = torch.where(listed[:, None], w, 0)  # ids not listed read nothing
    ext = _shifted(words, P.shape[1])
    accs = [torch.ones(w.shape, dtype=torch.bool, device=words.device)
            for _ in range(4)]
    for k in range(P.shape[1]):
        x = ext[src + k]
        for a in range(4):
            # Words the pattern does not touch have M = P = 0: always true.
            accs[a] &= (x & M[a, k]) == P[a, k]
    nib = torch.zeros(w.shape, dtype=torch.int32, device=words.device)
    for a, acc in enumerate(accs):
        nib |= (acc & listed[:, None]).to(torch.int32) << a
    nib = _valid_nibbles(nib, w, n_lim)
    bsr = popcount4(nib).view(-1, BLOCK_WORDS).sum(1, dtype=torch.int32)
    return nib.view(-1, 8, BLOCK_WORDS), bsr, bsr.sum(dtype=torch.int32)


def gather_verify(words: torch.Tensor, g8: torch.Tensor, n_lim: int,
                  P: torch.Tensor, M: torch.Tensor):
    """K11d, the exact verify of listed 4 KiB groups of the text.

    ``words``: int32[Nw], the text's words, Nw a multiple of 1024 (whole
    groups); ``g8``: int32[G] group ids, group g holding words
    1024g..1024g+1023; ``n_lim``: the largest valid start byte; ``P``/``M``
    as ``naive_nib``.  Returns (nib int32[G, 8, 128], bsr int32[8G], total
    int32 scalar tensor): row r of nib[i] is ``naive_nib``'s nibble plane of
    block 8 g8[i] + r (bit a of word c = match at byte
    4096 g8[i] + 512 r + 4c + a, kept only where that is <= n_lim), bsr
    its popcounts and total their sum.  An id outside [0, Nw/1024), such
    as the fill id Nw/1024, gives zero rows.  Replaces
    ``exp/proto_kernels.py::_gv_kernel`` (csrc/swar.cu notes what bounds
    it)."""
    _check(words, P, M)
    _check_group_ids(words, g8)
    if words.device.type == "cpu":
        return gather_verify_plain(words, g8, n_lim, P, M)
    n_ids = g8.numel()
    nib = torch.empty((n_ids, 8, BLOCK_WORDS), dtype=torch.int32,
                      device=words.device)
    bsr = torch.empty(n_ids * 8, dtype=torch.int32, device=words.device)
    total = torch.empty((), dtype=torch.int32, device=words.device)
    _launch("tpm_gather_verify", words.device, words.data_ptr(), words.numel(),
            int(n_lim), g8.data_ptr(), n_ids, P.data_ptr(), M.data_ptr(),
            P.shape[1], nib.data_ptr(), bsr.data_ptr(), total.data_ptr())
    gather_verify.launches += 1
    return nib, bsr, total


gather_verify.launches = 0


def decode_width(n: int, m: int, capacity: int) -> int:
    """Offset slots a pattern gets from ``decode_blocks``: ``capacity``, or
    fewer where the text has fewer starts (n - m + 1)."""
    return max(0, min(capacity, n - m + 1))


def decode_segments(n_words: int, limit: int) -> int:
    """Warp segments of ``decode_blocks``: the 512-byte blocks that hold a
    start <= ``limit``, in runs of ``SEGMENT_BLOCKS``."""
    if limit < 0:
        return 0
    blocks = min(limit // BLOCK_BYTES + 1, n_words // BLOCK_WORDS)
    return -(-blocks // SEGMENT_BLOCKS)


def _check_decode(words, flags, Ps, M, m: int, pmask: bool) -> None:
    if Ps.dim() != 3 or Ps.shape[0] < 1 or not Ps.is_contiguous():
        raise ValueError(f"Ps must be a contiguous [k, 4, nw], got {tuple(Ps.shape)}")
    _check(words, Ps[0], M)
    if words.numel() % GROUP_WORDS:
        raise ValueError(
            f"words must hold a whole number of 4 KiB rows, got {words.numel()} words")
    if Ps.shape[2] != (m + 6) // 4 or not 1 <= m <= MAX_PATTERN:
        raise ValueError(f"Ps has {Ps.shape[2]} words, m = {m} needs {(m + 6) // 4}")
    if pmask and Ps.shape[0] > 32:
        raise ValueError(f"a pattern mask names at most 32 patterns, got {Ps.shape[0]}")
    if (flags.dtype != torch.int32 or flags.dim() != 1 or not flags.is_contiguous()
            or flags.device != words.device):
        raise ValueError(
            f"flags must be contiguous 1-D int32 on {words.device}, got {flags.dtype} "
            f"{tuple(flags.shape)} on {flags.device}")
    if flags.numel() * BLOCK_WORDS > words.numel():
        raise ValueError(f"{flags.numel()} block flags for {words.numel()} words")


def decode_blocks_plain(words, flags, Ps, M, cut: int, n: int, m: int,
                        capacity: int, pmask: bool = False):
    """Plain PyTorch version of ``decode_blocks`` (same contract): the chain
    the kernel replaces.  Per pattern ``ops/reconstruct.extract_region``
    gathers and verifies the 4 KiB chunks of its flagged blocks (the K2
    rescan past the gather's width) up to min(n - m, cut - 1), and the tail
    [cut, N) takes the naive start mask (``ops/naive.naive_start_mask``),
    merged after it (``ops/emit.merge_tail``).  Slots past a pattern's
    count hold -1."""
    from ..ops import emit, naive, reconstruct  # they import this module

    k, width = Ps.shape[0], decode_width(n, m, capacity)
    regions = reconstruct.extract_region_multi(
        flags, reconstruct.full_words2d(words), Ps, M, m, min(n - m, cut - 1),
        width, pmask)
    text = words.view(torch.uint8)
    counts = torch.zeros(k, dtype=torch.int64, device=words.device)
    offsets = torch.full((k, width), -1, dtype=torch.int64, device=words.device)
    for p, region in enumerate(regions):
        with span("tpumatch.tail"):
            tail = naive.naive_start_mask(text[cut:], Ps[p, 0].view(torch.uint8)[:m])
        c, o, _ = emit.merge_tail(*region, cut, n, m, width, tail)
        counts[p] = c
        offsets[p, : o.numel()] = o
    return counts, offsets


def decode_blocks(words: torch.Tensor, flags: torch.Tensor, Ps: torch.Tensor,
                  M: torch.Tensor, cut: int, n: int, m: int, capacity: int,
                  pmask: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Every valid start [0, n - m] of k m-byte patterns, from a scan's
    block flags over the kernel region.

    ``words``: int32[Nw], the whole padded text (Nw a multiple of 1024, N =
    4 Nw bytes); ``flags``: int32[NB], the scan's flag of each 512-byte
    block of the region [0, 512 NB): with ``pmask`` bit p names pattern p
    (K6, k <= 32), otherwise a nonzero names every pattern (block sums);
    flagged blocks must hold every start < ``cut`` that matches.  ``Ps``:
    int32[k, 4, nw] the patterns' SWAR words (``pattern_words``), ``M``
    their masks (``mask_words(m)``).  The blocks from ``cut`` on (the tail
    the scan did not cover) are verified for every pattern, so no plain
    mask follows.  Returns (counts int64[k], offsets int64[k, width]),
    width = ``decode_width(n, m, capacity)``: counts[p] is pattern p's
    exact count of starts <= n - m and offsets[p, :min(counts[p], width)]
    its first starts, ascending; the slots after them are not defined.
    Both stay on the device: the caller reads the counts once.

    Replaces no TPU kernel: it replaces the host-driven chain of
    ``decode_blocks_plain`` (csrc/swar.cu notes what bounds it).  Three
    launches, no host read, under the ``tpumatch.extract`` span."""
    _check_decode(words, flags, Ps, M, m, pmask)
    if words.device.type == "cpu":
        return decode_blocks_plain(words, flags, Ps, M, cut, n, m, capacity, pmask)
    k, nw, dev = Ps.shape[0], Ps.shape[2], words.device
    width, limit = decode_width(n, m, capacity), n - m
    n_segs = decode_segments(words.numel(), limit)
    counts = torch.empty(k, dtype=torch.int64, device=dev)
    offsets = torch.empty((k, width), dtype=torch.int64, device=dev)
    seg_counts = torch.empty(k * n_segs, dtype=torch.int32, device=dev)
    seg_base = torch.empty(k * n_segs, dtype=torch.int64, device=dev)
    with span("tpumatch.extract"):
        _launch("tpm_decode_blocks", dev, words.data_ptr(), words.numel(),
                flags.data_ptr(), flags.numel(), Ps.data_ptr(), M.data_ptr(), nw,
                m, k, int(pmask), int(cut), limit, n_segs, seg_counts.data_ptr(),
                seg_base.data_ptr(), counts.data_ptr(), offsets.data_ptr(), width)
    decode_blocks.launches += 1
    return counts, offsets


decode_blocks.launches = 0


def pack_nibbles(mask: torch.Tensor) -> torch.Tensor:
    """bool[4N] start mask -> int32[N] nibble plane (bit a of word w = start
    at byte 4w + a)."""
    shifts = torch.arange(4, dtype=torch.int32, device=mask.device)
    return (mask.view(-1, 4).to(torch.int32) << shifts).sum(1, dtype=torch.int32)
