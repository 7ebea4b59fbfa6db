"""Corpus I/O: byte-array loading, padding, and seeded corpus generation.

A numpy-only copy of the JAX package's ``utils/io.py`` (importing that
module would import jax through its package ``__init__``).  The generators
are byte-identical to the reference's, so both packages see the same
corpora from the same seed.  Text is always treated as raw bytes — Unicode
safety falls out of matching UTF-8 byte sequences directly.
"""

from __future__ import annotations

import os

import numpy as np

_WORDS = (
    b"the quick brown fox jumps over lazy dog and cat with some very common "
    b"english words that repeat often in natural text corpus pattern match "
    b"string search algorithm parallel device memory vector lane tile shard"
).split()


def as_byte_array(data) -> np.ndarray:
    """Coerce bytes/str/ndarray/path-like into a uint8 numpy array (no copy
    when possible)."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        # The matchers reinterpret the buffer as int32 words
        # (padded.view(np.int32)); a non-contiguous user array would make
        # that view raise, so normalize here (no copy when already flat).
        return np.ascontiguousarray(data)
    if isinstance(data, str):
        data = data.encode("utf-8")
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    if isinstance(data, os.PathLike):
        return load_file(os.fspath(data))
    raise TypeError(f"cannot interpret {type(data)!r} as bytes")


def load_file(path: str, offset: int = 0, length: int | None = None) -> np.ndarray:
    """Memory-map a file slice as uint8 (used per-host for sharded corpora:
    each host mmaps its own slice plus the (m-1)-byte halo — overlapping file
    reads need no inter-host communication, SURVEY.md §3.3)."""
    arr = np.memmap(path, dtype=np.uint8, mode="r")
    if length is None:
        length = len(arr) - offset
    return np.asarray(arr[offset : offset + length])


def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad a uint8 array up to the next multiple (device-shape friendly)."""
    n = len(arr)
    target = -(-max(n, 1) // multiple) * multiple
    if target == n:
        return arr
    out = np.zeros(target, dtype=np.uint8)
    out[:n] = arr
    return out


# ---------------------------------------------------------------------------
# Seeded corpus generators (conformance + bench corpora, BASELINE.json:7-11)
# ---------------------------------------------------------------------------


def gen_english(n_bytes: int, seed: int = 0) -> bytes:
    """English-like word soup (config 1: 100MB English corpus)."""
    rng = np.random.default_rng(seed)
    chunks, size = [], 0
    # Draw words in large batches for speed.
    while size < n_bytes:
        idx = rng.integers(0, len(_WORDS), size=65536)
        batch = b" ".join(_WORDS[i] for i in idx) + b" "
        chunks.append(batch)
        size += len(batch)
    return b"".join(chunks)[:n_bytes]


def gen_dna(n_bytes: int, seed: int = 0) -> bytes:
    """Uniform 4-symbol DNA corpus (config 4)."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n_bytes).tobytes()


def gen_binary(n_bytes: int, seed: int = 0) -> bytes:
    """Uniform full-byte-alphabet corpus."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=n_bytes, dtype=np.uint8).tobytes()


def gen_utf8(n_chars: int, seed: int = 0) -> bytes:
    """Mixed-width UTF-8 corpus: ASCII, Latin-1 supplement, CJK, emoji
    (config 4 requires UTF-8; matching is byte-level so multi-byte sequences
    exercise halo/boundary correctness)."""
    rng = np.random.default_rng(seed)
    pool = (
        [chr(c) for c in range(0x20, 0x7F)]
        + [chr(c) for c in range(0xC0, 0x100)]
        + [chr(c) for c in range(0x4E00, 0x4E80)]
        + ["\U0001F600", "\U0001F680", "\U0001F9E0"]
    )
    idx = rng.integers(0, len(pool), size=n_chars)
    return "".join(pool[i] for i in idx).encode("utf-8")


GENERATORS = {
    "english": gen_english,
    "dna": gen_dna,
    "binary": gen_binary,
    "utf8": gen_utf8,
}
