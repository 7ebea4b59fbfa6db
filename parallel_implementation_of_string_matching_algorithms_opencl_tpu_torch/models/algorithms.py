"""The four single-pattern matchers: naive, Rabin-Karp, KMP, Boyer-Moore
(counterparts of the classes in the JAX ``models/algorithms.py``).

Each runs the same pipeline on a padded text of N bytes.  With
``emission='sparse'`` (the default):

1. a scan kernel over the kernel region [0, Nk) emits per-512-byte-block
   counts: exact matches (naive, K3 ``swar.naive_bsums``; Boyer-Moore with
   ``bm_screen='fused'`` or ``bm_probes='table_dyn'``, K7/K8
   ``swar.screened_bsums``), or candidates that the extraction verifies
   and recounts (Boyer-Moore's probe screen K1
   ``swar.screen_cand_bsums``, Rabin-Karp's rolling hash K5
   ``rk_roll.rk_candidate_bsums``, KMP's Shift-AND automaton K4
   ``shift_and.kmp_bsums``, exact for m <= 32 and a prefix screen above);
2. ``reconstruct.extract_blocks`` decodes every valid start from the
   block flags: the decode (``swar.decode_blocks``) verifies the flagged
   blocks and the tail [cut, N) the scan did not cover, and the counts are
   read once; a CUDA kernel on the card, its plain version (a byte compare
   of the same blocks) on the CPU.

With ``emission='nib'`` the scan kernel also writes the nibble plane of
its starts and step 2 decodes it (``emit.nibble_to_matches``): naive K2
``swar.naive_nib``, Boyer-Moore K7/K8 ``swar.screened_nib``, KMP K10a
``shift_and.kmp_nib`` (the whole pattern, m <= 256).  Rabin-Karp's plane
(K10b ``rk_roll.rk_candidate_nib``) holds hash candidates, whose windows
``ops/rabin_karp.verify_region`` verifies.  The tail [cut, N) then takes the
algorithm's plain mask, merged after the region.

Texts shorter than one kernel tile, and patterns a kernel does not take,
take the algorithm's plain mask (``_mask``) over the whole text.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rk_roll, shift_and, swar
from ..ops import boyer_moore as bm_ops
from ..ops import emit
from ..ops import kmp as kmp_ops
from ..ops import naive as naive_ops
from ..ops import rabin_karp as rk_ops
from ..ops import reconstruct
from ..ops import tables
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.profiling import span
from .base import Matcher
from .registry import register_matcher


def tables_from_reference(tables_np: dict, probe_layout, device) -> dict:
    """Device tensors for a matcher's numpy tables (the dict a JAX or port
    matcher keeps as ``tables``).  The reference's lane-replicated Shift-AND
    halves (``sa_bt``/``sa_bt32``, int32[K, 2, 8, 128]) become the port's
    int32[K, 256] tables; uint32 tables (Rabin-Karp ``powers`` and
    ``pattern_hash``) become int64 of the same values.  ``probe_layout``
    (a JAX matcher's ``config.bm_probe_layout``, Boyer-Moore only) is
    checked into tuple form under ``"probes"``; pass None for the other
    matchers."""
    out = {}
    for k, v in tables_np.items():
        v = np.asarray(v)
        if k in ("sa_bt", "sa_bt32") and v.ndim == 4:
            v = shift_and.b_table_from_halves(v)
        if v.dtype == np.uint32:
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(np.array(v, order="C")).to(device)
    if probe_layout is not None:
        layout = tuple(tuple(int(k) for k in ks) for ks in probe_layout)
        if len(layout) != 4 or any(not 1 <= len(ks) <= 2 for ks in layout):
            raise ValueError(f"bad probe layout {probe_layout!r}")
        out["probes"] = layout
    return out


def _swar_tables(pat: np.ndarray) -> dict:
    return {"swar_p": swar.pattern_words(pat)[0]}


class _RegionMatcher(Matcher):
    """Shared by the four matchers: device tables, the byte masks that the
    extraction verifies with, and the region + tail merge."""

    def __init__(self, pattern: bytes, config: MatchConfig = DEFAULT_CONFIG,
                 device="cuda"):
        super().__init__(pattern, config, device)
        self.swar_m = torch.from_numpy(swar.mask_words(self.m)).to(self.device)
        self.dev_tables = tables_from_reference(self.tables,
                                                self._probe_layout(),
                                                self.device)

    def _probe_layout(self):
        return None

    def _merge_tail(self, c1, o1, v1, text, n: int, cut: int):
        """(count, offsets, overflow) of a region's result merged with the
        algorithm's plain start mask over the tail [cut, N)."""
        with span("tpumatch.tail"):
            tail = self._mask(text[cut:])
        return emit.merge_tail(c1, o1, v1, cut, n, self.m,
                               self.config.capacity, tail)

    def _nib_and_tail(self, nib, bs, text, n: int, cut: int):
        """(count, offsets, overflow) from the region's exact nibble plane
        ``nib`` and block sums ``bs`` (validity min(n-m, cut-1) applied in
        the kernel) and the tail."""
        return self._merge_tail(
            *emit.nibble_to_matches(nib, bs, self.config.capacity), text, n,
            cut)

    def _region_and_tail(self, bs, text, n: int, cut: int):
        """(count, offsets, overflow) of every start from the region's
        block flags ``bs``, the tail [cut, N) included
        (``reconstruct.extract_blocks``).  Validity is the logical n, not
        the padded N: padded N lets a pattern ending in NUL bytes match
        inside the zero padding."""
        return reconstruct.extract_blocks(
            bs, text.view(torch.int32), self.dev_tables["swar_p"][None],
            self.swar_m, cut, n, self.m, self.config.capacity)[0]


@register_matcher
class NaiveMatcher(_RegionMatcher):
    """Exact verify of every start: K3 with offsets by the chunk gather, or
    K2's nibble plane under ``emission='nib'``."""

    name = "naive"

    def _precompute(self, pat: np.ndarray) -> dict:
        return _swar_tables(pat)

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
        limit = min(n - m, cut - 1)
        region = text.view(torch.int32)[: Nk // 4]
        P = self.dev_tables["swar_p"]
        if self.config.emission == "nib":
            with span("tpumatch.scan"):
                nib, bs = swar.naive_nib(region, limit, P, self.swar_m)
            return self._nib_and_tail(nib, bs, text, n, cut)
        with span("tpumatch.scan"):
            bs = swar.naive_bsums(region, limit, P, self.swar_m)
        return self._region_and_tail(bs, text, n, cut)


@register_matcher
class RabinKarpMatcher(_RegionMatcher):
    """Rolling hash mod 2**32 as a candidate screen (K5, or K10b's
    candidate plane under ``emission='nib'``) + exact verify."""

    name = "rabin_karp"

    @classmethod
    def _tile_bytes(cls, config: MatchConfig) -> int:
        return 128 * config.pallas_chunk_bytes

    def _precompute(self, pat: np.ndarray) -> dict:
        c = tables.rk_constants(len(pat), self.config.rk_base)
        return {
            "powers": c["powers"],
            "pattern_hash": tables.rk_hash(pat, c),
            **_swar_tables(pat),
        }

    def _mask(self, text: torch.Tensor) -> torch.Tensor:
        t = self.dev_tables
        return rk_ops.rk_start_mask(text, self.pattern_dev, t["powers"],
                                    t["pattern_hash"],
                                    self.config.verify_capacity)

    def _direct(self, text: torch.Tensor, n: int):
        m = self.m
        if not rk_roll.rk_roll_supported(m):
            return None
        Nk, cut = shift_and.kernel_region(text.shape[0], m,
                                          self.config.pallas_chunk_bytes)
        if Nk == 0:
            return None
        cfg = self.config
        base = int(tables.RK_BASE) if cfg.rk_base is None else cfg.rk_base
        region = text.view(torch.int32)[: Nk // 4]
        limit = min(n - m, cut - 1)
        target = self.dev_tables["pattern_hash"].reshape(1)
        if cfg.emission == "nib":
            # The count comes from the verify, never from bs: hash hits are
            # candidates.
            with span("tpumatch.scan"):
                nib, bs = rk_roll.rk_candidate_nib(region, limit, target, m,
                                                   base)
            n_cand, cand, _ = emit.nibble_to_matches(nib, bs,
                                                     cfg.verify_capacity)
            return self._merge_tail(
                *rk_ops.verify_region(text, self.pattern_dev, cand, n_cand,
                                      limit, cfg.verify_capacity, cfg.capacity),
                text, n, cut)
        # Hash hits are candidates: the extraction verifies and recounts.
        with span("tpumatch.scan"):
            bs = rk_roll.rk_candidate_bsums(region, limit, target, m, base)
        return self._region_and_tail(bs, text, n, cut)


@register_matcher
class KMPMatcher(_RegionMatcher):
    """Prefix automaton: the Shift-AND kernel (K4) over the region, the
    dense DFA (``ops/kmp``) over the tail and where the kernel does not run.

    - m <= 32: the one-word automaton of the whole pattern; its block sums
      are exact.
    - 32 < m <= 509 with ``kmp_long='screen'`` (default): the one-word
      automaton of ``pattern[:32]`` as a candidate screen, clamped at its own
      n - 32; the extraction verifies the full pattern and re-clamps at
      n - m, which alone makes the result exact near the end of the text.
    - 32 < m <= 256 with ``kmp_long='ripple'``: the K-word automaton of the
      whole pattern.
    - ``emission='nib'``, m <= 256: the K-word automaton of the whole
      pattern with its nibble plane (K10a), whatever ``kmp_long`` says: no
      verify follows a nibble plane, so a prefix screen would count
      prefix-only starts.  m > 256 takes the dense DFA over the whole text.
    """

    name = "kmp"

    # The screen's bound: the extraction verifies with the SWAR words,
    # whose halo covers m <= swar.MAX_PATTERN (509).
    MAX_SCREEN_M = swar.MAX_PATTERN
    SCREEN_M = 32

    @classmethod
    def _tile_bytes(cls, config: MatchConfig) -> int:
        return 128 * config.pallas_chunk_bytes

    def _precompute(self, pat: np.ndarray) -> dict:
        t = {"dfa": tables.kmp_dfa(pat), **_swar_tables(pat)}
        if shift_and.shift_and_supported(len(pat)):
            t["sa_bt"] = shift_and.b_table(pat)
        if self.SCREEN_M < len(pat) <= self.MAX_SCREEN_M:
            t["sa_bt32"] = shift_and.b_table(pat[: self.SCREEN_M])
        return t

    def _screen_mode(self) -> bool:
        return (self.m > self.SCREEN_M and self.config.kmp_long == "screen"
                and self.config.emission == "sparse"
                and "sa_bt32" in self.dev_tables)

    def _mask(self, text: torch.Tensor) -> torch.Tensor:
        return kmp_ops.kmp_start_mask(text, self.dev_tables["dfa"],
                                      self.config.kmp_chunk)

    def _direct(self, text: torch.Tensor, n: int):
        m = self.m
        if self._screen_mode():
            bt, mk = self.dev_tables["sa_bt32"], self.SCREEN_M
        elif "sa_bt" in self.dev_tables:
            bt, mk = self.dev_tables["sa_bt"], m
        else:
            return None
        Nk, cut = shift_and.kernel_region(text.shape[0], m,
                                          self.config.pallas_chunk_bytes)
        if Nk == 0:
            return None
        region = text.view(torch.int32)[: Nk // 4]
        if self.config.emission == "nib":  # mk == m: never the screen
            with span("tpumatch.scan"):
                nib, bs = shift_and.kmp_nib(region, min(n - m, cut - 1), bt,
                                            m)
            return self._nib_and_tail(nib, bs, text, n, cut)
        # The kernel's own clamp, min(n, Nk) - mk: for the screen it counts
        # prefix starts in (n - m, n - 32] too, which the extraction's
        # limit n - m rejects.
        with span("tpumatch.scan"):
            bs = shift_and.kmp_bsums(region, min(n, Nk) - mk, bt, mk)
        return self._region_and_tail(bs, text, n, cut)


@register_matcher
class BoyerMooreMatcher(_RegionMatcher):
    """Bad-char + good-suffix Boyer-Moore, as probe screen + exact verify.
    The probes are the pattern words that Boyer-Moore's bad-character and
    good-suffix shifts score as rarest: the vectorized form of BM's skip
    rule.

    - sparse, ``bm_screen='cand'``: K1 counts candidate words and the
      extraction verifies them (the default);
    - sparse, ``bm_screen='fused'`` or ``bm_probes='table_dyn'``: K7/K8
      verify the words with a probe hit in the kernel, the extraction
      gathers the offsets from the exact block counts;
    - ``emission='nib'``: K7/K8 with the nibble plane, decoded directly.

    ``table_dyn`` takes its probes from ``swar_pr`` (the reference's
    runtime probe table); the other probe modes from the layout stamped
    into the config, or the positional probes for ``'static'``.

    ``bm_variant='cursor'`` runs no kernel: the reference's lane-cursor
    skip loop (``ops/boyer_moore.bm_start_mask_cursor``, ``bm_chunk``-byte
    lanes, the ``bad_char`` and ``good_suffix`` tables) over the whole
    padded text on the matcher's device.  ``'filtered'`` texts that take
    no kernel take the naive mask, which gives the same answer."""

    name = "boyer_moore"

    @classmethod
    def _specialize_config(cls, config: MatchConfig,
                           pat: np.ndarray) -> MatchConfig:
        if config.bm_probes in ("table", "table_gs", "table_gs1"):
            # Always recompute: a config recycled from another pattern's
            # matcher would carry that pattern's layout.
            layout = swar.static_probes_from_table(
                swar.probe_table(
                    pat, use_gs=config.bm_probes in ("table_gs", "table_gs1"),
                    single=config.bm_probes == "table_gs1",
                )
            )
            if layout != config.bm_probe_layout:
                return config.replace(bm_probe_layout=layout)
        return config

    def _probe_layout(self):
        if self.config.bm_probes == "table_dyn":
            return swar.static_probes_from_table(self.tables["swar_pr"])
        layout = self.config.bm_probe_layout
        if layout is None:  # bm_probes='static': positional probes
            layout = swar.probe_indices(swar.mask_words(self.m))
        return layout

    def _precompute(self, pat: np.ndarray) -> dict:
        t = {
            "bad_char": tables.bm_bad_char(pat),
            "good_suffix": tables.bm_good_suffix(pat),
            **_swar_tables(pat),
        }
        if self.config.bm_probes == "table_dyn":
            # The reference's runtime probe table (bad-character scores).
            t["swar_pr"] = swar.probe_table(pat)
        return t

    def _mask(self, text: torch.Tensor) -> torch.Tensor:
        if self.config.bm_variant == "cursor":
            t = self.dev_tables
            return bm_ops.bm_start_mask_cursor(text, self.pattern_dev,
                                               t["bad_char"], t["good_suffix"],
                                               self.config.bm_chunk)
        return naive_ops.naive_start_mask(text, self.pattern_dev)

    def _direct(self, text: torch.Tensor, n: int):
        m = self.m
        if self.config.bm_variant == "cursor" or not swar.swar_supported(m):
            return None
        Nk, cut = swar.kernel_region(text.shape[0], m,
                                     self.config.pallas_chunk_bytes)
        if Nk == 0:
            return None
        cfg, t = self.config, self.dev_tables
        # The region's largest valid start is the kernels' clamp.
        args = (text.view(torch.int32)[: Nk // 4], min(n - m, cut - 1),
                t["swar_p"], self.swar_m, t["probes"])
        if cfg.emission == "nib":
            with span("tpumatch.scan"):
                nib, bs = swar.screened_nib(*args)
            return self._nib_and_tail(nib, bs, text, n, cut)
        with span("tpumatch.scan"):
            if cfg.bm_screen == "fused" or cfg.bm_probes == "table_dyn":
                bs = swar.screened_bsums(*args)
            else:
                bs = swar.screen_cand_bsums(*args)
        return self._region_and_tail(bs, text, n, cut)
