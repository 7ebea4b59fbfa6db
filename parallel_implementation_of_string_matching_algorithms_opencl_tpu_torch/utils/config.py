"""Match configuration (counterpart of the JAX package's ``utils/config.py``).

Only the fields the single-pattern Boyer-Moore path reads are carried.  The
JAX-only switches (``use_pallas``, ``interpret``, the AOT cache) have no
meaning here: on a CUDA tensor the kernels always run, on a CPU tensor their
plain PyTorch versions do.  Modes of the reference that this package does not
implement yet raise ``NotImplementedError`` at construction.
"""

from __future__ import annotations

import dataclasses

# Boyer-Moore probe selections whose screen is the candidate kernel with
# probes fixed per pattern.  'table_gs' (default) scores probe words by
# bad-character plus good-suffix shift, 'table' by bad-character shift alone,
# 'static' takes the first and last full pattern words.
PORTED_PROBES = ("table_gs", "table", "static")
# Reference modes not ported yet (ROADMAP.md, Queue 2).
UNPORTED = {
    "bm_variant": ("cursor",),
    "bm_screen": ("fused",),
    "emission": ("nib",),
    "bm_probes": ("table_dyn", "table_gs1"),
}


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Knobs for a match run (field meanings as in the JAX package)."""

    # Offset-buffer capacity per call (counts stay exact on overflow).
    capacity: int = 65536
    # Boyer-Moore screen probe selection (see PORTED_PROBES).
    bm_probes: str = "table_gs"
    # Concrete per-pattern probe layout (tuple[4] of tuples of word
    # indices), stamped by BoyerMooreMatcher at construction.
    bm_probe_layout: tuple | None = None
    # 'filtered': probe screen + exact verify of the candidates.
    bm_variant: str = "filtered"
    # 'cand': the screen kernel emits candidate block sums, verification
    # happens in ops/reconstruct.extract_region.
    bm_screen: str = "cand"
    # Pad text length to a multiple of this (4096 = one 1024-word row, so
    # the (N/4096, 1024) int32 word view always exists).
    pad_multiple: int = 4096
    # Tile geometry shared with the JAX package: the kernel region is the
    # text floored to 128 * min(pallas_chunk_bytes, 4096) bytes, so one
    # config puts the kernel/tail seam at the same byte in both packages.
    pallas_chunk_bytes: int = 16384
    # 'sparse': the kernels emit per-512-byte block sums and offsets are
    # reconstructed from gathered candidate chunks.
    emission: str = "sparse"

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
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        for field, values in UNPORTED.items():
            if getattr(self, field) in values:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r} is not ported to the "
                    f"PyTorch package yet (ROADMAP.md, Queue 2)"
                )
        if self.bm_probes not in PORTED_PROBES:
            raise ValueError(f"unknown bm_probes {self.bm_probes!r}")
        for field, ok in (("bm_variant", "filtered"), ("bm_screen", "cand"),
                          ("emission", "sparse")):
            if getattr(self, field) != ok:
                raise ValueError(f"unknown {field} {getattr(self, field)!r}")

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MatchConfig()
