"""Matcher base: pattern precompute + device execution + results
(counterpart of the JAX ``models/base.py``).

A matcher is host-side table precompute plus ``run``, the device-resident
pipeline from a padded uint8 text tensor to (count, offsets, overflow).
Matchers hold no learned parameters, so they are plain classes holding
device tensors.  The device is explicit: ``"cuda"`` raises when CUDA is
absent, and the CPU runs only when asked for (the tests do).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..ops import emit
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.io import as_byte_array, pad_to_multiple


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without CUDA raises
    instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 host array -> tensor on ``device``.  A read-only array (e.g.
    ``np.frombuffer`` of bytes) is wrapped without a copy: the pipeline
    never writes to its input."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        host = torch.from_numpy(arr)
    return host.to(device)


def valid_prefix(off: np.ndarray) -> np.ndarray:
    """Ascending valid prefix of an offset buffer: stop at the first hole
    (negative entry), so ``offsets`` stays a true prefix of the match
    set."""
    bad = np.nonzero(off < 0)[0]
    return off[: bad[0]] if bad.size else off


@dataclasses.dataclass
class MatchResult:
    """Host-facing result: exact count and sorted 0-based byte offsets.

    ``offsets`` is an ascending PREFIX of the match set (overlapping
    occurrences included).  If ``overflow`` is True it holds the first
    ``capacity`` matches only; ``count`` is still exact, and
    ``match_all`` / ``drain=True`` recovers every offset.
    """

    algo: str
    pattern: bytes
    n: int
    count: int
    offsets: np.ndarray
    overflow: bool

    def offsets_list(self) -> list[int]:
        return [int(x) for x in self.offsets]


class Matcher:
    """Base matcher: subclass with ``name``, ``_precompute`` and ``_mask``."""

    name = "base"

    def __init__(self, pattern: bytes, config: MatchConfig = DEFAULT_CONFIG,
                 device="cuda"):
        if len(pattern) == 0:
            raise ValueError("empty pattern")
        self.device = resolve_device(device)
        self.pattern_bytes = bytes(pattern)
        self.m = len(pattern)
        pat = np.frombuffer(self.pattern_bytes, dtype=np.uint8)
        # Per-pattern config specialization (the BM probe layout); use
        # ``matcher.config``, not the config the caller constructed.
        self.config = self._specialize_config(config, pat)
        self.pattern_arr = pat
        self.pattern_dev = to_device(pat, self.device)
        self.tables = self._precompute(pat)

    # -- subclass hooks -----------------------------------------------------

    @classmethod
    def _specialize_config(cls, config: MatchConfig,
                           pat: np.ndarray) -> MatchConfig:
        """Stamp concrete per-pattern choices into the config.  Default:
        unchanged."""
        return config

    def _precompute(self, pat: np.ndarray) -> dict:
        """Host-side table precompute: a dict of numpy arrays, equal to
        the JAX matcher's ``tables``."""
        return {}

    def _mask(self, text: torch.Tensor) -> torch.Tensor:
        """bool[N] start mask of the whole padded text; must be
        overridden."""
        raise NotImplementedError

    def _direct(self, text: torch.Tensor, n: int):
        """Kernel path: (count, offsets, overflow), or None to take the
        ``_mask`` route."""
        return None

    # -- shared kernel-region + tail merge for _direct implementations ----

    def _merge_tail(self, c1, o1, v1, cut: int, n: int, tail_mask):
        """Merge an extracted kernel region [0, cut) with a bool tail mask
        over [cut, N)."""
        if tail_mask.shape[0] == 0:
            return c1, o1, v1
        tail_valid = emit.valid_start_mask(tail_mask, n - cut, self.m)
        c2, o2, v2 = emit.mask_to_matches_sorted(
            tail_valid, min(self.config.capacity, tail_mask.shape[0])
        )
        return emit.merge_region_matches(
            c1, o1, v1, c2, o2, v2, self.config.capacity, cut
        )

    # -- execution ----------------------------------------------------------

    def run(self, text: torch.Tensor, n: int):
        """Device-resident pipeline: ``text`` is the padded uint8 text on
        ``self.device`` (length a multiple of 4096), ``n`` its logical
        length.  Returns (count, int64 offsets tensor, overflow)."""
        direct = self._direct(text, n)
        if direct is not None:
            return direct
        mask = emit.valid_start_mask(self._mask(text), n, self.m)
        return emit.mask_to_matches_sorted(mask, self.config.capacity)

    def match(self, data) -> MatchResult:
        arr = as_byte_array(data)
        n = len(arr)
        padded = pad_to_multiple(arr, self._pad_target(n))
        count, offsets, overflow = self.run(to_device(padded, self.device), n)
        offs = valid_prefix(offsets.cpu().numpy())
        return MatchResult(
            algo=self.name,
            pattern=self.pattern_bytes,
            n=n,
            count=count,
            offsets=offs,
            overflow=bool(overflow) or len(offs) < count,
        )

    def match_all(self, data) -> MatchResult:
        """Like ``match`` but returns EVERY offset even when the count
        exceeds ``config.capacity``, by windowed re-extraction
        (``extract_range``)."""
        arr = as_byte_array(data)
        res = self.match(arr)
        if not res.overflow:
            return res
        offsets = self.extract_range(arr, 0, len(arr), res.count)
        if len(offsets) != res.count:
            raise RuntimeError(
                f"drain found {len(offsets)} offsets for count {res.count}"
            )
        return dataclasses.replace(res, offsets=offsets, overflow=False)

    def extract_range(self, arr: np.ndarray, lo: int, hi: int,
                      est: int) -> np.ndarray:
        """EVERY match offset starting in ``[lo, hi)``.  Each window reads
        (m-1) halo bytes past its end, so the per-window validity limit
        p <= len(window)-m is exactly start-ownership and the concatenation
        is duplicate-free and ascending.  ``est``: expected match count in
        the range; windows hold ~capacity/2 expected matches, and a window
        that still overflows splits in half (a ``capacity``-byte window
        holds at most ``capacity`` starts, which ends the recursion)."""
        cap = self.config.capacity
        pm = max(1, self.config.pad_multiple)
        span = hi - lo
        if span <= 0:
            return np.empty(0, np.int64)
        est = max(1, est)
        W = int(max(cap, min(span, span * cap // (2 * est) + 1)))
        W = -(-W // pm) * pm  # shape reuse across windows

        parts = []

        def drain(wlo: int, w: int) -> None:
            r = self.match(arr[wlo : wlo + w + self.m - 1])
            if not r.overflow:
                if r.count:
                    parts.append(np.asarray(r.offsets, np.int64) + wlo)
                return
            if w <= cap:
                raise RuntimeError("a capacity-byte window overflowed")
            half = -(-(w // 2) // pm) * pm
            if half >= w:
                half = w // 2
            drain(wlo, half)
            drain(wlo + half, w - half)

        for wlo in range(lo, hi, W):
            drain(wlo, min(W, hi - wlo))
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    @classmethod
    def _tile_bytes(cls, config: MatchConfig) -> int:
        """Kernel tile size: padding the text to a tile multiple makes the
        kernels cover (almost) everything and shrinks the tail to the last
        m-1 bytes plus padding."""
        return 128 * min(config.pallas_chunk_bytes, 4096)

    def _pad_target(self, n: int) -> int:
        """Pad-to multiple for ``match``: always word-row aligned (the
        (N/4096, 1024) int32 view must exist), tile-aligned once the text
        fills a tile.  Shorter texts take the ``_mask`` route."""
        tile = self._tile_bytes(self.config)
        return int(np.lcm(self.config.pad_multiple, tile if n >= tile else 4096))
