"""The plain reference against a brute force, on small texts with planted
near misses and overlapping matches."""

import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import reference  # noqa: E402


def brute(text: bytes, n: int, pat: bytes) -> list:
    return [p for p in range(n - len(pat) + 1) if text[p : p + len(pat)] == pat]


def planted(seed: int, pat: bytes, n: int) -> bytes:
    """Random bytes over a small alphabet with the pattern, its overlapping
    repeats and near misses (one byte changed) written in."""
    rng = random.Random(seed)
    t = bytearray(rng.choice(b"ab") for _ in range(n))
    for _ in range(n // 50):
        at = rng.randrange(n)
        kind = rng.randrange(3)
        s = pat if kind == 0 else pat + pat[-1:] * 3 if kind == 1 else bytearray(pat)
        if kind == 2:
            s[rng.randrange(len(pat))] ^= 1
        t[at : at + len(s)] = bytes(s)[: n - at]
    return bytes(t[:n])


@pytest.mark.parametrize("pat", [b"a", b"aa", b"aba", b"abab", b"aab", b"\x00a",
                                 b"ba" * 9])
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_brute_force(pat, seed, monkeypatch):
    monkeypatch.setattr(reference, "CHUNK", 97)  # many chunk seams
    n = 3000
    text = planted(seed, pat, n)
    dev = torch.tensor(list(text) + [0] * 64, dtype=torch.uint8)
    got = reference.find_all(dev, n, pat)
    assert got.dtype == np.int64
    assert got.tolist() == brute(text, n, pat)


def test_logical_length_not_padding():
    text = torch.tensor(list(b"xxab") + [0] * 8, dtype=torch.uint8)
    assert reference.find_all(text, 4, b"b\x00").tolist() == []
    assert reference.find_all(text, 5, b"b\x00").tolist() == [3]
    assert reference.find_all(text, 3, b"xxab").tolist() == []


def test_truncated_compare_finds_more():
    text = planted(3, b"abbaabab", 4000)
    dev = torch.tensor(list(text), dtype=torch.uint8)
    full = reference.find_all(dev, 4000, b"abbaabab")
    weak = reference.find_all(dev, 4000, b"abbaabab", reference.truncated(8))
    assert set(full.tolist()) < set(weak.tolist())
    assert [reference.truncated(m) for m in (1, 4, 16, 24, 256)] == [1, 2, 8, 8, 8]
