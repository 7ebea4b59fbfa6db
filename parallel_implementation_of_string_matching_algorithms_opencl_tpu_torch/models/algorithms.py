"""Boyer-Moore matcher (counterpart of ``BoyerMooreMatcher`` in the JAX
``models/algorithms.py``; the naive, Rabin-Karp and KMP matchers are still
to be ported, ROADMAP.md Queue 1).

Pipeline on a padded text of N bytes:

1. K1 (``swar.screen_cand_bsums``): the probe screen over the kernel
   region [0, Nk) emits candidate words per 512-byte block.  The probes
   are the pattern words that Boyer-Moore's bad-character and good-suffix
   shifts score as rarest — the vectorized form of BM's skip rule.
2. ``reconstruct.extract_region`` verifies the candidate chunks exactly
   (escalating to the K2 rescan when they are too many).
3. The tail [cut, N) is a plain shifted compare, merged after the region.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import swar
from ..ops import naive as naive_ops
from ..ops import reconstruct
from ..ops import tables
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from .base import Matcher
from .registry import register_matcher


def tables_from_reference(tables_np: dict, probe_layout, device) -> dict:
    """Device tensors for a matcher's numpy tables (the dict a JAX or port
    matcher keeps as ``tables``), plus the probe layout (a JAX matcher's
    ``config.bm_probe_layout``) checked into tuple form."""
    layout = tuple(tuple(int(k) for k in ks) for ks in probe_layout)
    if len(layout) != 4 or any(not 1 <= len(ks) <= 2 for ks in layout):
        raise ValueError(f"bad probe layout {probe_layout!r}")
    out = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in tables_np.items()
    }
    out["probes"] = layout
    return out


@register_matcher
class BoyerMooreMatcher(Matcher):
    """Bad-char + good-suffix Boyer-Moore, as probe screen + exact verify."""

    name = "boyer_moore"

    def __init__(self, pattern: bytes, config: MatchConfig = DEFAULT_CONFIG,
                 device="cuda"):
        super().__init__(pattern, config, device)
        layout = self.config.bm_probe_layout
        if layout is None:  # bm_probes='static': positional probes
            layout = swar.probe_indices(swar.mask_words(self.m))
        self.swar_m = torch.from_numpy(swar.mask_words(self.m)).to(self.device)
        self.dev_tables = tables_from_reference(self.tables, layout,
                                                self.device)

    @classmethod
    def _specialize_config(cls, config: MatchConfig,
                           pat: np.ndarray) -> MatchConfig:
        if config.bm_probes in ("table", "table_gs"):
            # Always recompute: a config recycled from another pattern's
            # matcher would carry that pattern's layout.
            layout = swar.static_probes_from_table(
                swar.probe_table(pat, use_gs=config.bm_probes == "table_gs")
            )
            if layout != config.bm_probe_layout:
                return config.replace(bm_probe_layout=layout)
        return config

    def _precompute(self, pat: np.ndarray) -> dict:
        return {
            "bad_char": tables.bm_bad_char(pat),
            "good_suffix": tables.bm_good_suffix(pat),
            "swar_p": swar.pattern_words(pat)[0],
        }

    def _mask(self, text: torch.Tensor) -> torch.Tensor:
        return naive_ops.naive_start_mask(text, self.pattern_dev)

    def _direct(self, text: torch.Tensor, n: int):
        m = self.m
        if not swar.swar_supported(m):
            return None
        Nk, cut = swar.kernel_region(text.shape[0], m,
                                     self.config.pallas_chunk_bytes)
        if Nk == 0:
            return None
        t = self.dev_tables
        words = text.view(torch.int32)
        # Logical n, not padded N: padded N lets a pattern ending in NUL
        # bytes match inside the zero padding.  The region's largest valid
        # start is both K1's clamp and extract_region's limit.
        limit = min(n - m, cut - 1)
        bs = swar.screen_cand_bsums(words[: Nk // 4], limit, t["swar_p"],
                                    self.swar_m, t["probes"])
        c1, o1, v1 = reconstruct.extract_region(
            bs, reconstruct.full_words2d(words), t["swar_p"], self.swar_m, m,
            limit, self.config.capacity,
        )
        tail = naive_ops.naive_start_mask(text[cut:], self.pattern_dev)
        return self._merge_tail(c1, o1, v1, cut, n, tail)
