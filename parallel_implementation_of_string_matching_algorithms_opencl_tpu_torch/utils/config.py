"""Match configuration (counterpart of the JAX package's ``utils/config.py``).

Only the fields the matchers (naive, Rabin-Karp, KMP, Boyer-Moore and
multi-pattern Rabin-Karp) and the sharded paths read are carried.  The JAX-only switches (``use_pallas``,
``interpret``, the AOT cache) have no meaning here: on a CUDA tensor the
kernels always run, on a CPU tensor their plain PyTorch versions do.  Every
mode of the reference's fields is implemented.
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
BM_PROBES = ("table_gs", "table", "static", "table_dyn", "table_gs1")
# Boyer-Moore variant: 'filtered' runs the probe screen and an exact verify
# of its candidates (the kernels above); 'cursor' runs the reference's
# lane-cursor skip loop (ops/boyer_moore.bm_start_mask_cursor): one cursor
# per bm_chunk bytes, all stepping by max(bad-character, good-suffix) shift
# until each leaves its chunk.  No kernel: plain PyTorch on the device.
BM_VARIANT = ("filtered", "cursor")
# Boyer-Moore screen execution under sparse emission: 'cand' counts probe
# candidates per block (K1) and the decode (kernels/swar.decode_blocks)
# verifies the flagged blocks; 'fused' verifies every word with a probe hit
# in the kernel (K7) and the decode verifies again the blocks it counts.
BM_SCREEN = ("cand", "fused")
# Offset emission: 'sparse' kernels emit per-512-byte block counts and the
# offsets come from the decode of those flags (kernels/swar.decode_blocks:
# a CUDA kernel on the card, its plain version on the CPU); 'nib' kernels
# also write the full nibble plane (bit a of int32 word w = a start at byte
# 4w + a) and the offsets are decoded from the blocks that hold them
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
# block against every pattern; 'pselect' with k > 31 takes 'blocks'.
# 'groups' (m <= 33; longer patterns take 'blocks') screens with 16-bit
# occupancy masks (K10c, bit g of a block = a candidate start in its
# 32-byte group g) and verifies every pattern only on the occupied groups
# (ops/reconstruct.extract_region_multi_groups), any k.  Under 'nib' one
# candidate plane over all k targets (K10b) feeds every pattern's verify,
# whatever this field says.
MULTI_GATHER = ("pselect", "blocks", "groups")
# Offset merge of the sharded paths (parallel/dist.py): 'count_sized'
# gathers each rank's offset row cut to a power-of-two bucket at least its
# largest per-shard count (``_pick_bucket``), so the traffic scales with the
# result; 'fixed' gathers capacity-wide rows without sizing them first.
DIST_GATHER = ("count_sized", "fixed")


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Knobs for a match run (field meanings as in the JAX package)."""

    # Offset-buffer capacity per call (counts stay exact on overflow); 0 is
    # count-only: no offsets, overflow exactly when there is a match.
    capacity: int = 65536
    # Rabin-Karp candidates verified by a gathered window compare; more take
    # a full shifted compare (ops/rabin_karp.verify_candidates).
    verify_capacity: int = 131072
    # Lane chunk length of the KMP dense-DFA scan (ops/kmp.kmp_start_mask).
    kmp_chunk: int = 2048
    # KMP kernel execution for m > 32 (see KMP_LONG).
    kmp_long: str = "screen"
    # Boyer-Moore screen probe selection (see BM_PROBES).
    bm_probes: str = "table_gs"
    # Concrete per-pattern probe layout (tuple[4] of tuples of word
    # indices), stamped by BoyerMooreMatcher at construction.
    bm_probe_layout: tuple | None = None
    # Boyer-Moore variant (see BM_VARIANT).
    bm_variant: str = "filtered"
    # Lane chunk length of the Boyer-Moore cursor skip loop.
    bm_chunk: int = 4096
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
    # Offset merge of the sharded paths (see DIST_GATHER).
    dist_gather: str = "count_sized"

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
        if self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        for field in ("verify_capacity", "kmp_chunk", "bm_chunk"):
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
        for field, values in (("bm_probes", BM_PROBES),
                              ("bm_variant", BM_VARIANT),
                              ("bm_screen", BM_SCREEN),
                              ("emission", EMISSION),
                              ("multi_gather", MULTI_GATHER),
                              ("dist_gather", DIST_GATHER)):
            if getattr(self, field) not in values:
                raise ValueError(f"unknown {field} {getattr(self, field)!r}")

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MatchConfig()
