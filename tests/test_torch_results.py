"""PyTorch port: the results hand-off, ``models/base.make_result`` and
``valid_prefix``, from ``run``'s (count, offsets, overflow) to a host
``MatchResult``.

On the CPU the offsets are read in place and no ``tpumatch.result.copy``
span is recorded; every answer equals the one of the route before the
page-locked copy (``offsets.cpu().numpy()`` and a scan of the whole buffer
for its first hole, kept here as ``_old_result``).  The tests marked
``cuda`` hold the page-locked route on the card against that route, byte
for byte, and skip without a GPU.  This file imports neither jax nor the
JAX package, so it also runs where ``tests/conftest.py`` must be left out:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_results.py
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    get_matcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models import (
    base,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
    RabinKarpMatcher,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
    pad_to_multiple,
)

I64 = np.int64


def _old_valid_prefix(off: np.ndarray) -> np.ndarray:
    bad = np.nonzero(off < 0)[0]
    return off[: bad[0]] if bad.size else off


def _old_result(count, offsets: torch.Tensor, overflow) -> tuple:
    """(count, offsets, overflow) as ``make_result`` gave them before the
    page-locked copy."""
    offs = _old_valid_prefix(offsets.cpu().numpy())
    return count, offs, bool(overflow) or len(offs) < count


def _same(res, want) -> None:
    count, offs, overflow = want
    assert res.count == count and res.overflow is overflow
    assert isinstance(res.offsets, np.ndarray)
    assert res.offsets.dtype == offs.dtype
    assert res.offsets.tobytes() == offs.tobytes()


def _spans(fn) -> tuple:
    """(fn's output, [(name, start, end)] of its ``tpumatch.result``
    spans) of one call under a CPU ``torch.profiler.profile``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("tpumatch.result")]
    return out, spans


# case -> (buffer, its valid prefix)
PREFIXES = {
    "empty": ([], []),
    "one": ([0], [0]),
    "all_valid": ([3, 7, 9, 12], [3, 7, 9, 12]),
    "hole_first": ([-1, 3, 7], []),
    "hole_middle": ([3, 7, -1, 12, 15], [3, 7]),
    "hole_last": ([3, 7, 9, -1], [3, 7, 9]),
    "several_holes": ([3, -1, 9, -1, -1], [3]),
    "all_holes": ([-1, -1, -1], []),
    "other_negative": ([4, 5, -7, 8], [4, 5]),
    "past_2_40": ([5, 2**40 + 3, 2**62 + 1], [5, 2**40 + 3, 2**62 + 1]),
}


@pytest.mark.parametrize("case", list(PREFIXES))
def test_valid_prefix_stops_at_the_first_hole(case):
    """The prefix before the first negative entry, as the scan of the
    whole buffer gave it; a buffer without a hole comes back as the same
    object, and a prefix is a view of the buffer, values unchanged."""
    buf, want = PREFIXES[case]
    off = np.array(buf, I64)
    got = base.valid_prefix(off)
    assert got.dtype == I64 and got.tolist() == want
    assert got.tolist() == _old_valid_prefix(off).tolist()
    if (off >= 0).all():
        assert got is off
    elif got.size:
        assert np.shares_memory(got, off)


# case -> (count, offsets, overflow) as ``run`` returns them
TRIPLES = {
    "hole_free": (3, [1, 5, 9], False),
    # the prefix is short of the count: overflow turns True
    "hole": (4, [1, 5, -1, -1], False),
    "count_past_capacity": (10, [0, 2, 4, 6], True),
    "empty": (0, [], False),
}


@pytest.mark.parametrize("case", list(TRIPLES))
def test_make_result_on_cpu_offsets(case):
    """CPU offsets take the route without a copy: the valid prefix of the
    buffer itself, ``overflow`` also where it is short of the count."""
    count, buf, overflow = TRIPLES[case]
    offsets = torch.tensor(buf, dtype=torch.int64)
    res = base.make_result("rabin_karp", b"ab", 100, count, offsets,
                           overflow)
    _same(res, _old_result(count, offsets, overflow))
    assert (res.algo, res.pattern, res.n) == ("rabin_karp", b"ab", 100)
    if res.offsets.size:
        assert np.shares_memory(res.offsets, offsets.numpy())


TEXT = gen_english(2 << 20, seed=23)
PAT = b"quick brown"
LIST = [b"quick brown", b"lazy dog an", b"jumps over "]


def _cpu_run(algo, pats, config):
    """(matcher, padded CPU text, n) for ``pats`` under ``algo``."""
    if isinstance(pats, list):
        m = RabinKarpMultiMatcher(pats, config, device="cpu")
        tile = RabinKarpMatcher._tile_bytes(m.config)
    else:
        m = get_matcher(algo)(pats, config, device="cpu")
        tile = m._tile_bytes(m.config)
    n = len(TEXT)
    mult = base.pad_target(n, m.config, tile)
    text = base.to_device(pad_to_multiple(np.frombuffer(TEXT, np.uint8), mult),
                          torch.device("cpu"))
    return m, text, n


# case -> (algorithm, pattern or list, config)
RUNS = {
    "bm": ("boyer_moore", PAT, MatchConfig()),
    "naive": ("naive", PAT, MatchConfig()),
    "kmp": ("kmp", PAT, MatchConfig()),
    "rk": ("rabin_karp", PAT, MatchConfig()),
    "rk_list": ("rabin_karp", LIST, MatchConfig()),
    "bm_overflow": ("boyer_moore", b"e ", MatchConfig(capacity=64)),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_make_result_of_a_cpu_run(case):
    """``make_result`` of each route's ``run`` on the CPU: the old route's
    answer and the oracle's (its first ``capacity`` offsets)."""
    algo, pats, config = RUNS[case]
    m, text, n = _cpu_run(algo, pats, config)
    multi = isinstance(pats, list)
    triples = m.run(text, n) if multi else [m.run(text, n)]
    for p, (count, offsets, overflow) in zip(pats if multi else [pats],
                                            triples):
        res = base.make_result(m.name, p, n, count, offsets, overflow)
        _same(res, _old_result(count, offsets, overflow))
        want = find_all(TEXT, p)
        assert res.count == len(want)
        assert res.offsets_list() == want[: config.capacity]
        assert res.overflow is (len(want) > config.capacity)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "list"])
def test_no_result_copy_span_on_the_cpu(multi):
    """On the CPU a result records its ``tpumatch.result`` and no
    ``tpumatch.result.copy``: the page-locked copy engages on the card
    alone."""
    if multi:
        mm = RabinKarpMultiMatcher(LIST, device="cpu")
        fn = lambda: mm.match(TEXT)  # noqa: E731
    else:
        fn = lambda: match(TEXT, PAT, device="cpu")  # noqa: E731
    out, spans = _spans(fn)
    names = [s[0] for s in spans]
    assert names == ["tpumatch.result"] * (len(LIST) if multi else 1)
    for r, p in zip(out if multi else [out], LIST if multi else [PAT]):
        assert r.offsets_list() == find_all(TEXT, p)


# -- on the card -------------------------------------------------------------

DENSE = b"dense pattern 16"  # 16 bytes, planted every 64 bytes
CARD_N = 8 << 20


@pytest.fixture(scope="module")
def card_text():
    """(padded uint8 text on the card, n, host bytes): 8 MiB of English
    with ``DENSE`` planted every 64 bytes of its first half; the test
    skips without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    data = bytearray(gen_english(CARD_N, seed=5))
    for off in range(0, CARD_N // 2, 64):
        data[off : off + len(DENSE)] = DENSE
    data = bytes(data)
    # Rabin-Karp's tile is the larger, and both are powers of two.
    mult = base.pad_target(CARD_N, MatchConfig(),
                           RabinKarpMatcher._tile_bytes(MatchConfig()))
    padded = pad_to_multiple(np.frombuffer(data, np.uint8), mult)
    return base.to_device(padded, torch.device("cuda")), CARD_N, data


def _card_results(m, text, n, pats) -> list:
    """[(result, the old route's answer)] of one ``run`` on the card."""
    triples = m.run(text, n)
    if not isinstance(pats, list):
        triples, pats = [triples], [pats]
    return [(base.make_result(m.name, p, n, *t), _old_result(*t))
            for p, t in zip(pats, triples)]


def _pinned(arr: np.ndarray) -> bool:
    return torch.from_numpy(arr).is_pinned()


SIXTEEN = [b"quick brown fox ", b"lazy dog and cat", b"parallel device ",
           b"search algorithm", DENSE, b"jumps over the l",
           b"over the lazy do", b"brown fox jumps "]


# case -> (pattern or list, capacity or None for the default)
CARD_CASES = {
    "bm_dense": (DENSE, None),
    "bm_sparse": (b"quick brown fox ", None),
    "rk8_dense": (SIXTEEN, None),
    "overflow": (DENSE, 8192),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_results_equal_the_pageable_route(card_text, case):
    """The route of each result on the card gives the ``.cpu()`` route's
    count, offsets (byte for byte) and overflow on the decode's outputs:
    one Boyer-Moore pattern with many results and one with few, a k = 8
    Rabin-Karp group with one dense pattern, and a result past its
    capacity; offsets of ``PINNED_MIN_OFFSETS`` or more are page-locked,
    fewer are not, and every result matches the oracle."""
    text, n, data = card_text
    pats, cap = CARD_CASES[case]
    config = MatchConfig() if cap is None else MatchConfig(capacity=cap)
    cap = config.capacity
    m = (RabinKarpMultiMatcher(pats, config, device="cuda")
         if isinstance(pats, list)
         else BoyerMooreMatcher(pats, config, device="cuda"))
    out = _card_results(m, text, n, pats)
    for (res, want), p in zip(out, pats if isinstance(pats, list) else [pats]):
        _same(res, want)
        oracle = find_all(data, p)
        assert res.count == len(oracle)
        assert res.offsets_list() == oracle[:cap]
        assert res.overflow is (len(oracle) > cap)
        if res.offsets.size:
            assert _pinned(res.offsets) is (
                len(res.offsets) >= base.PINNED_MIN_OFFSETS)
    firsts = [r for r, _w in out]
    if case == "bm_sparse":
        assert 0 < firsts[0].count < base.PINNED_MIN_OFFSETS
    else:
        dense = firsts[SIXTEEN.index(DENSE)] if case == "rk8_dense" else firsts[0]
        assert dense.count == CARD_N // 128
        assert _pinned(dense.offsets)
    if case == "overflow":
        assert firsts[0].overflow and len(firsts[0].offsets) == cap


@pytest.mark.cuda
def test_card_result_survives_later_queries(card_text):
    """A result keeps its offsets while 20 further queries take page-locked
    blocks of the same sizes from the caching allocator: each result owns
    its block until it is freed."""
    text, n, _data = card_text
    m = RabinKarpMultiMatcher(SIXTEEN, device="cuda")
    held = [r for r, _w in _card_results(m, text, n, SIXTEEN)]
    kept = [r.offsets.copy() for r in held]
    # each pattern's offsets land in the blocks another's took before
    turns = [SIXTEEN[i:] + SIXTEEN[:i] for i in range(1, 8)]
    others = [RabinKarpMultiMatcher(p, device="cuda") for p in turns]
    for i in range(20):
        for res, want in _card_results(others[i % 7], text, n, turns[i % 7]):
            _same(res, want)
    for r, k in zip(held, kept):
        assert r.offsets.tobytes() == k.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "sparse", "rk8"])
def test_card_records_one_copy_span_a_page_locked_result(card_text, case):
    """Under ``torch.profiler`` each result on the card of
    ``PINNED_MIN_OFFSETS`` offsets or more records one
    ``tpumatch.result.copy``, inside its ``tpumatch.result``; a shorter
    one records none."""
    text, n, _data = card_text
    pats = {"dense": DENSE, "sparse": b"quick brown fox ",
            "rk8": SIXTEEN}[case]
    m = (RabinKarpMultiMatcher(pats, device="cuda") if case == "rk8"
         else BoyerMooreMatcher(pats, device="cuda"))
    _card_results(m, text, n, pats)  # warm
    out, spans = _spans(lambda: _card_results(m, text, n, pats))
    locked = sum(len(r.offsets) >= base.PINNED_MIN_OFFSETS for r, _w in out)
    assert locked == (case == "dense") if case != "rk8" else locked >= 1
    names = [s[0] for s in spans]
    assert names.count("tpumatch.result") == len(out)
    assert names.count("tpumatch.result.copy") == locked
    results = [s for s in spans if s[0] == "tpumatch.result"]
    for _name, lo, hi in (s for s in spans if s[0] == "tpumatch.result.copy"):
        assert any(rlo <= lo and hi <= rhi for _n, rlo, rhi in results)
