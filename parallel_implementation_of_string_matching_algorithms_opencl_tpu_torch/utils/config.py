"""Match configuration (counterpart of the JAX package's ``utils/config.py``).

Only the fields the matchers (naive, Rabin-Karp, KMP, Boyer-Moore and
multi-pattern Rabin-Karp) read are carried.  The JAX-only switches (``use_pallas``,
``interpret``, the AOT cache) have no meaning here: on a CUDA tensor the
kernels always run, on a CPU tensor their plain PyTorch versions do.  Modes of the reference that this package does not
implement yet raise ``NotImplementedError`` at construction.
"""

from __future__ import annotations

import dataclasses

# Boyer-Moore probe selections.  'table_gs' (default) scores probe words by
# bad-character plus good-suffix shift, 'table' by bad-character shift alone,
# 'table_gs1' keeps only the best 'table_gs' word per alignment (one probe,
# a weaker screen), 'static' takes the first and last full pattern words.
# These fix the probes per pattern and screen with K1 (sparse) or K7.
# 'table_dyn' takes the bad-character-scored pair as the reference's
# runtime probes and always runs the screen-then-verify kernel (K8, the
# same CUDA kernel as K7: a runtime probe index costs nothing here).
PORTED_PROBES = ("table_gs", "table", "static", "table_dyn", "table_gs1")
# Boyer-Moore screen execution under sparse emission: 'cand' counts probe
# candidates per block (K1) and extract_region verifies them; 'fused'
# verifies every word with a probe hit in the kernel (K7) and extract_region
# verifies again from the exact block counts.
BM_SCREEN = ("cand", "fused")
# Offset emission: 'sparse' kernels emit per-512-byte block counts and the
# offsets come from verifying gathered candidate chunks
# (ops/reconstruct.extract_region); 'nib' kernels also write the full
# nibble plane (bit a of int32 word w = a start at byte 4w + a) and the
# offsets are decoded from the blocks that hold them
# (ops/emit.nibble_to_matches).
EMISSION = ("sparse", "nib")
# KMP execution for m > 32 under sparse emission: 'screen' runs the
# one-word automaton of pattern[:32] as a candidate screen, 'ripple' the
# K-word automaton of the whole pattern (m <= 256).  'nib' always runs the
# K-word automaton (m <= 256): no verify follows a nibble plane.
KMP_LONG = ("screen", "ripple")
# Multi-pattern candidate extraction under sparse emission: 'pselect'
# screens with per-block pattern-hit masks (K6, k <= 31) and verifies each
# block only against the patterns flagged in it; 'blocks' screens with
# candidate counts over all k targets (K5) and verifies every candidate
# block against every pattern.  k > 31 always takes 'blocks'.  Under 'nib'
# one candidate plane over all k targets (K10b) feeds every pattern's
# verify.
MULTI_GATHER = ("pselect", "blocks")
# Reference modes not ported yet (ROADMAP.md, Queue 2).
UNPORTED = {
    "bm_variant": ("cursor",),
    "multi_gather": ("groups",),
}


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Knobs for a match run (field meanings as in the JAX package)."""

    # Offset-buffer capacity per call (counts stay exact on overflow).
    capacity: int = 65536
    # Rabin-Karp candidates verified by a gathered window compare; more take
    # a full shifted compare (ops/rabin_karp.verify_candidates).
    verify_capacity: int = 131072
    # Lane chunk length of the KMP dense-DFA scan (ops/kmp.kmp_start_mask).
    kmp_chunk: int = 2048
    # KMP kernel execution for m > 32 (see KMP_LONG).
    kmp_long: str = "screen"
    # Boyer-Moore screen probe selection (see PORTED_PROBES).
    bm_probes: str = "table_gs"
    # Concrete per-pattern probe layout (tuple[4] of tuples of word
    # indices), stamped by BoyerMooreMatcher at construction.
    bm_probe_layout: tuple | None = None
    # 'filtered': probe screen + exact verify of the candidates.
    bm_variant: str = "filtered"
    # Boyer-Moore screen execution under sparse emission (see BM_SCREEN).
    bm_screen: str = "cand"
    # Pad text length to a multiple of this (4096 = one 1024-word row, so
    # the (N/4096, 1024) int32 word view always exists).
    pad_multiple: int = 4096
    # Tile geometry shared with the JAX package: the kernel region is the
    # text floored to 128 * min(pallas_chunk_bytes, 4096) bytes for the
    # SWAR kernels (naive, Boyer-Moore) and to 128 * pallas_chunk_bytes for
    # the KMP and Rabin-Karp kernels, so one config puts the kernel/tail
    # seam at the same byte in both packages.
    pallas_chunk_bytes: int = 16384
    # Offset emission (see EMISSION).
    emission: str = "sparse"
    # Rabin-Karp base (an odd uint32); None = ops.tables.RK_BASE.
    rk_base: int | None = None
    # Multi-pattern candidate extraction (see MULTI_GATHER).
    multi_gather: str = "pselect"

    def __post_init__(self):
        if self.pad_multiple < 4 or self.pad_multiple % 4:
            raise ValueError(
                f"pad_multiple must be a positive multiple of 4 "
                f"(int32 word view), got {self.pad_multiple}"
            )
        if self.pallas_chunk_bytes < 512 or self.pallas_chunk_bytes % 512:
            raise ValueError(
                f"pallas_chunk_bytes must be a positive multiple of 512 "
                f"(whole 512-byte blocks per chunk), got "
                f"{self.pallas_chunk_bytes}"
            )
        for field in ("capacity", "verify_capacity", "kmp_chunk"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"{field} must be >= 1, got {getattr(self, field)}")
        if self.kmp_long not in KMP_LONG:
            raise ValueError(f"unknown kmp_long {self.kmp_long!r}")
        if self.rk_base is not None and not (
            0 < self.rk_base < 1 << 32 and self.rk_base % 2
        ):
            raise ValueError(
                f"rk_base must be an odd uint32 (invertible mod 2**32), got "
                f"{self.rk_base}")
        for field, values in UNPORTED.items():
            if getattr(self, field) in values:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r} is not ported to the "
                    f"PyTorch package yet (ROADMAP.md, Queue 2)"
                )
        if self.bm_probes not in PORTED_PROBES:
            raise ValueError(f"unknown bm_probes {self.bm_probes!r}")
        if self.multi_gather not in MULTI_GATHER:
            raise ValueError(f"unknown multi_gather {self.multi_gather!r}")
        if self.bm_variant != "filtered":
            raise ValueError(f"unknown bm_variant {self.bm_variant!r}")
        for field, values in (("bm_screen", BM_SCREEN),
                              ("emission", EMISSION)):
            if getattr(self, field) not in values:
                raise ValueError(f"unknown {field} {getattr(self, field)!r}")

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MatchConfig()
