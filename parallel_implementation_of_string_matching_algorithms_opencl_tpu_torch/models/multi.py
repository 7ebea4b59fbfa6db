"""Multi-pattern Rabin-Karp (counterpart of the JAX ``models/multi.py``;
BASELINE config 2: 8 patterns over a 1 GB corpus).

k patterns of one length share one hash pass over the kernel region
[0, Nk) (``csrc/rk_roll.cu`` ``rk_warp_kernel``, a warp per 512-byte block
on prefix hashes, whichever of K5, K6, K10b or K10c the route takes), then
each pattern is extracted exactly on its own:

- ``multi_gather='pselect'`` (default, k <= 31): K6
  ``rk_roll.rk_candidate_pmask`` marks, per 512-byte block, which patterns'
  hashes hit there, and each pattern verifies only its own blocks;
- ``'blocks'``, and ``'pselect'`` with k > 31: K5
  ``rk_roll.rk_candidate_bsums`` counts hits of any of the k hashes, and
  every pattern verifies every candidate block;
- ``reconstruct.extract_blocks`` decodes every valid start of every
  pattern from those flags, the tail [cut, N) included: on the card one
  CUDA decode (``swar.decode_blocks``) and one read of the k counts; on the
  CPU its plain version, ``reconstruct.extract_region_multi`` per pattern
  (the K2 rescan for a pattern with more candidate chunks than the gather
  width) and a naive tail mask;
- ``'groups'``, any k, m <= 33: K10c ``rk_roll.rk_candidate_bmask`` marks,
  per block, which 32-byte groups hold a hit of any of the k hashes, and
  ``reconstruct.extract_region_multi_groups`` verifies each pattern on
  those groups only (past its gather width, ``extract_blocks`` on the
  blocks with a group); m > 33 takes ``'blocks'``, as in the reference;
- ``emission='nib'``: K10b ``rk_roll.rk_candidate_nib`` writes one
  candidate plane over all k hashes, its first ``verify_capacity``
  candidates are decoded once, and each pattern verifies them at their
  windows (``ops/rabin_karp.verify_region``; an exact compare of the region
  when there are more), whatever ``multi_gather`` says;
- after ``'groups'`` and ``emission='nib'`` the tail [cut, N) takes
  ``ops/rabin_karp.rk_multi_start_masks``, merged per pattern.

Texts shorter than one kernel tile, m = 1 and m > 509 take
``rk_multi_start_masks`` over the whole text.  ``api.match`` groups a list
of patterns by length and runs one matcher per group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rk_roll, shift_and, swar
from ..ops import emit, reconstruct, tables
from ..ops import rabin_karp as rk_ops
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.io import as_byte_array
from ..utils.profiling import span
from .algorithms import RabinKarpMatcher, tables_from_reference
from .base import (MatchResult, make_result, pad_target, resolve_device, stage,
                   to_device)


class RabinKarpMultiMatcher:
    """k equal-length patterns, one shared hash pass."""

    name = "rabin_karp_multi"

    def __init__(self, patterns, config: MatchConfig = DEFAULT_CONFIG,
                 device="cuda"):
        if not patterns:
            raise ValueError("no patterns")
        lengths = {len(p) for p in patterns}
        if len(lengths) != 1:
            raise ValueError(
                f"RabinKarpMultiMatcher needs equal-length patterns, got {lengths}"
            )
        if 0 in lengths:
            raise ValueError("empty pattern")
        self.device = resolve_device(device)
        self.patterns = [bytes(p) for p in patterns]
        self.m = len(self.patterns[0])
        self.k = len(self.patterns)
        self.config = config
        self.pattern_arr = np.stack(
            [np.frombuffer(p, dtype=np.uint8) for p in self.patterns]
        )
        consts = tables.rk_constants(self.m, config.rk_base)
        # The JAX matcher's tables: powers uint32[m], hashes uint32[k] and
        # the SWAR words int32[k, 4, nw] that extraction verifies with.
        self.tables = {
            "powers": consts["powers"],
            "hashes": np.array(
                [tables.rk_hash(p, consts) for p in self.pattern_arr],
                dtype=np.uint32,
            ),
            "swar_ps": np.stack(
                [swar.pattern_words(p)[0] for p in self.pattern_arr]
            ),
        }
        self.dev_tables = tables_from_reference(self.tables, None, self.device)
        self.patterns_dev = to_device(self.pattern_arr, self.device)
        self.swar_m = torch.from_numpy(swar.mask_words(self.m)).to(self.device)

    def _masks(self, text: torch.Tensor) -> torch.Tensor:
        """bool[k, len(text)] exact start masks, plain route."""
        t = self.dev_tables
        return rk_ops.rk_multi_start_masks(text, self.patterns_dev,
                                           t["powers"], t["hashes"],
                                           self.config.verify_capacity)

    def run(self, text: torch.Tensor, n: int) -> list:
        """Device-resident pipeline: ``text`` is the padded uint8 text on
        ``self.device`` (length a multiple of 4096), ``n`` its logical
        length.  Returns k (count, int64 offsets tensor, overflow) triples
        in pattern order, each as ``Matcher.run`` returns it."""
        with span("tpumatch.run"):
            cfg, m = self.config, self.m
            Nk, cut = shift_and.kernel_region(text.shape[0], m,
                                              cfg.pallas_chunk_bytes)
            if not rk_roll.rk_roll_supported(m) or Nk == 0:
                return [
                    emit.mask_to_matches_sorted(emit.valid_start_mask(mk, n, m),
                                                cfg.capacity)
                    for mk in self._masks(text)
                ]
            base = int(tables.RK_BASE) if cfg.rk_base is None else cfg.rk_base
            words = text.view(torch.int32)
            limit = min(n - m, cut - 1)
            hashes = self.dev_tables["hashes"]
            if cfg.emission == "nib":
                with span("tpumatch.scan"):
                    nib, bs = rk_roll.rk_candidate_nib(words[: Nk // 4], limit,
                                                       hashes, m, base)
                n_cand, cand, _ = emit.nibble_to_matches(nib, bs,
                                                         cfg.verify_capacity)
                regions = [
                    rk_ops.verify_region(text, pat, cand, n_cand, limit,
                                         cfg.verify_capacity, cfg.capacity)
                    for pat in self.patterns_dev
                ]
            elif cfg.multi_gather == "groups" and self.swar_m.shape[1] <= 9:
                # The reference's gate: its 16-word group slab holds the
                # compare chain only for nw <= 9 pattern words (m <= 33).
                with span("tpumatch.scan"):
                    bm = rk_roll.rk_candidate_bmask(words[: Nk // 4], limit,
                                                    hashes, m, base)
                regions = reconstruct.extract_region_multi_groups(
                    bm, reconstruct.full_words2d(words),
                    self.dev_tables["swar_ps"], self.swar_m, m, limit,
                    cfg.capacity,
                )
                if regions is None:  # past the group gather's width
                    return self._decode((bm != 0).to(torch.int32), words, n,
                                        cut, pmask=False)
            else:
                pmask = (cfg.multi_gather == "pselect"
                         and self.k <= rk_roll.MAX_PMASK_PATTERNS)
                screen = (rk_roll.rk_candidate_pmask if pmask
                          else rk_roll.rk_candidate_bsums)
                with span("tpumatch.scan"):
                    bs = screen(words[: Nk // 4], limit, hashes, m, base)
                return self._decode(bs, words, n, cut, pmask)
            with span("tpumatch.tail"):
                tails = self._masks(text[cut:])
            return [
                emit.merge_tail(*region, cut, n, m, cfg.capacity, tail)
                for region, tail in zip(regions, tails)
            ]

    def _decode(self, flags, words, n: int, cut: int, pmask: bool) -> list:
        """Every pattern's (count, offsets, overflow) over [0, n - m] from
        the block flags of the kernel region (``reconstruct.extract_blocks``,
        the tail included)."""
        return reconstruct.extract_blocks(
            flags, words, self.dev_tables["swar_ps"], self.swar_m, cut, n,
            self.m, self.config.capacity, pmask)

    def match(self, data) -> list[MatchResult]:
        """One ``MatchResult`` per pattern, in pattern order.  The text is
        padded as ``RabinKarpMatcher`` pads it, so the tail is m - 1 bytes
        once the text fills a kernel tile."""
        with span("tpumatch.match"):
            arr = as_byte_array(data)
            n = len(arr)
            tile = RabinKarpMatcher._tile_bytes(self.config)
            text = stage(arr, pad_target(n, self.config, tile), self.device)
            out = self.run(text, n)
            return [make_result(self.name, p, n, *triple)
                    for p, triple in zip(self.patterns, out)]
