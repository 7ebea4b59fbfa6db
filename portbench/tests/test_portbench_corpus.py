"""The corpora made from the seed: the same seed gives the same bytes, and
the bytes follow the generators' distributions."""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import corpus, manifest  # noqa: E402

N = 1 << 20
KINDS = sorted(p.stem for p in (manifest.BENCH_DIR / "corpora").glob("*.py"))
WORDS = manifest.plugin("corpora", "english").WORDS


def test_every_kind_is_found():
    assert KINDS == ["dna", "english"]


@pytest.mark.parametrize("kind", KINDS)
def test_same_seed_same_bytes(kind):
    a = corpus.make(kind, N, N + 4096, 2**31 + 7, "cpu")
    b = corpus.make(kind, N, N + 4096, 2**31 + 7, "cpu")
    c = corpus.make(kind, N, N + 4096, 2**31 + 8, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not a[N:].any()


def test_dna_shares():
    t = corpus.make("dna", N, N, 11, "cpu").numpy()
    counts = {c: int((t == ord(c)).sum()) for c in "ACGT"}
    assert sum(counts.values()) == N
    for c in "ACGT":
        # four standard deviations of a binomial(N, 1/4)
        assert abs(counts[c] - N / 4) < 4 * (N * 3 / 16) ** 0.5, counts


def test_english_words_and_spaces():
    t = bytes(corpus.make("english", N, N, 12, "cpu").numpy())
    assert b"  " not in t and t[0:1] != b" "
    words = t.split(b" ")[:-1]  # the last word may be cut
    assert set(words) <= set(WORDS)
    freq = collections.Counter(words)
    expect = len(words) / len(WORDS)
    chi2 = sum((freq[w] - expect) ** 2 / expect for w in WORDS)
    # 34 degrees of freedom: 70 is beyond the 0.9999 quantile
    assert chi2 < 70, chi2
    lens = np.array([len(w) for w in words])
    mean = np.mean([len(w) for w in WORDS])
    assert abs(lens.mean() - mean) < 0.05


def test_english_crosses_chunks(monkeypatch):
    monkeypatch.setattr(corpus, "CHUNK", 1000)
    a = corpus.make("english", 10_000, 10_000, 5, "cpu")
    monkeypatch.setattr(corpus, "CHUNK", 1 << 26)
    assert torch.equal(a, corpus.make("english", 10_000, 10_000, 5, "cpu"))
