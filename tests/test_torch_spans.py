"""PyTorch port: the ``tpumatch.*`` spans of ``utils/profiling.span`` on
the CPU, read from ``torch.profiler``'s raw kineto events.

Each layer boundary of ``match`` and ``run`` records one span while a
profiler records, nested on the calling thread: ``tpumatch.match`` holds
``stage`` (``stage.pad``, ``stage.copy``), ``run`` (``scan``, ``extract``,
and ``tail`` on the routes that merge a plain tail mask) and ``result``.
The decode records one ``extract`` a call for every pattern of the call,
on the CPU as on the card.  Spans are ``cpu_op`` events, never
``user_annotation``s, which the profiler would project onto the card's
timeline.  With no profiler a span is one shared null context.  Their
runs on the card are in ``tests/test_torch_cuda.py``.
"""

import _torch_threads  # noqa: F401

import json

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    RabinKarpMultiMatcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models import (
    base,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
    profiling,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
    pad_to_multiple,
)

# Two kernel tiles of the Rabin-Karp and KMP matchers (128 * 16 KiB), so
# every algorithm takes its scan kernel's plain version and a tail.
TEXT = gen_english(2 << 20, seed=11)
PAT = b"quick brown"
LIST = [b"quick brown", b"lazy dog an", b"jumps over "]

# layer -> the span that encloses it (None: a root)
PARENT = {"tpumatch.stage": "tpumatch.match",
          "tpumatch.stage.pad": "tpumatch.stage",
          "tpumatch.stage.copy": "tpumatch.stage",
          "tpumatch.run": "tpumatch.match",
          "tpumatch.scan": "tpumatch.run",
          "tpumatch.extract": "tpumatch.run",
          "tpumatch.tail": "tpumatch.run",
          "tpumatch.result": "tpumatch.match"}


def _profiled(fn):
    """(fn's output, the profiler's raw events) of one call under a CPU
    ``torch.profiler.profile``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def _spans(events) -> list:
    """[name, start, end, parent name] of the ``tpumatch.`` spans, in
    order of start, each parent the innermost span that encloses it."""
    spans = sorted(([e.name(), e.start_ns(), e.start_ns() + e.duration_ns()]
                    for e in events if e.name().startswith("tpumatch.")),
                   key=lambda s: (s[1], -s[2]))
    stack = []
    for s in spans:
        while stack and stack[-1][2] <= s[1]:
            stack.pop()
        assert not stack or s[2] <= stack[-1][2], f"{s} crosses {stack[-1]}"
        s.append(stack[-1][0] if stack else None)
        stack.append(s)
    return spans


def _results(out) -> list:
    return [(r.count, r.offsets_list(), r.overflow)
            for r in (out if isinstance(out, list) else [out])]


def _want(pats, text=TEXT) -> list:
    return [(len(f), f, False) for f in (find_all(text, p) for p in pats)]


# case -> (the call, its patterns, the extract spans it records): one
# decode, or one group extraction, for every pattern of the list
CALLS = {
    "bm": (lambda: match(TEXT, PAT, device="cpu"), [PAT], 1),
    "naive": (lambda: match(TEXT, PAT, algo="naive", device="cpu"), [PAT], 1),
    "kmp": (lambda: match(TEXT, PAT, algo="kmp", device="cpu"), [PAT], 1),
    "rk": (lambda: match(TEXT, PAT, algo="rk", device="cpu"), [PAT], 1),
    "rk_list": (lambda: match(TEXT, LIST, algo="rk", device="cpu"), LIST, 1),
    "rk_groups": (lambda: match(TEXT, LIST, algo="rk", multi_gather="groups",
                                device="cpu"), LIST, 1),
}


@pytest.mark.parametrize("case", list(CALLS))
def test_match_records_the_span_tree(case):
    """One ``match`` call: each span under its layer's parent, one
    ``run``, one ``scan``, one ``extract``, a ``result`` per pattern and
    ``result`` after ``run``; a ``tail`` inside ``run`` only where the group
    extraction merges a tail mask, as on the card; the answers equal the
    oracle's with the profiler and without it."""
    fn, pats, extracts = CALLS[case]
    assert _results(fn()) == _want(pats)
    out, events = _profiled(fn)
    assert _results(out) == _want(pats)
    spans = _spans(events)
    names = [s[0] for s in spans]
    for name, _lo, _hi, parent in spans:
        assert parent == PARENT.get(name), (name, parent)
    k = len(pats)
    # the group route's tail masks, then a merge a pattern
    tails = {"tpumatch.tail": 1 + k} if case == "rk_groups" else {}
    assert {n: names.count(n) for n in set(names)} == {
        "tpumatch.match": 1, "tpumatch.stage": 1, "tpumatch.stage.pad": 1,
        "tpumatch.stage.copy": 1, "tpumatch.run": 1, "tpumatch.scan": 1,
        "tpumatch.extract": extracts, "tpumatch.result": k, **tails}
    run = next(s for s in spans if s[0] == "tpumatch.run")
    assert all(s[1] >= run[2] for s in spans if s[0] == "tpumatch.result")


def test_resident_run_is_the_root_and_result_follows():
    """The benchmark's resident query: ``run`` on a padded device text and
    ``make_result``, no ``match``, so ``run`` is the request's root."""
    m = BoyerMooreMatcher(PAT, device="cpu")
    n = len(TEXT)
    text = torch.from_numpy(pad_to_multiple(np.frombuffer(TEXT, np.uint8),
                                            m._pad_target(n)))
    out, events = _profiled(lambda: base.make_result(m.name, PAT, n,
                                                     *m.run(text, n)))
    assert _results(out) == _want([PAT])
    spans = _spans(events)
    roots = [s[0] for s in spans if s[3] is None]
    assert roots == ["tpumatch.run", "tpumatch.result"]
    assert {s[3] for s in spans} == {None, "tpumatch.run"}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "list"])
def test_dense_input_records_a_rescan_inside_extract(multi):
    """A dense input: the decode verifies every flagged block inside one
    ``tpumatch.extract`` under ``tpumatch.run``, and no rescan is
    recorded."""
    pats = [b"e t", b"s a"] if multi else [b"e t"]
    if multi:
        mm = RabinKarpMultiMatcher(pats, device="cpu")
        fn = lambda: mm.match(TEXT)  # noqa: E731
    else:
        fn = lambda: match(TEXT, pats[0], device="cpu")  # noqa: E731
    out, events = _profiled(fn)
    assert _results(out) == _want(pats)
    spans = _spans(events)
    extracts = [s for s in spans if s[0] == "tpumatch.extract"]
    assert len(extracts) == 1 and extracts[0][3] == "tpumatch.run"
    assert not [s for s in spans if s[0] == "tpumatch.rescan"]


def test_every_span_is_a_cpu_op():
    """A ``cpu_op``, never a ``user_annotation``: the profiler projects a
    user annotation onto the card's timeline, where it would count as
    device work and cover the card's idle gaps."""
    _out, events = _profiled(CALLS["rk_list"][0])
    spans = [e for e in events if e.name().startswith("tpumatch.")]
    assert spans
    assert not any(e.is_user_annotation() for e in spans)
    assert {e.device_type() for e in spans} == {torch.autograd.DeviceType.CPU}


def test_trace_writes_the_spans_into_its_json(tmp_path):
    """``profiling.trace``'s Chrome/Perfetto file holds the port's spans
    beside the other operations, as ``cpu_op``s."""
    with profiling.trace(str(tmp_path)):
        match(TEXT, PAT, device="cpu")
    (path,) = tmp_path.glob("trace_*.json")
    cats = {e["name"]: e.get("cat")
            for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("name", "")).startswith("tpumatch.")}
    assert set(cats) == {*PARENT, "tpumatch.match"} - {"tpumatch.tail"}
    assert set(cats.values()) == {"cpu_op"}


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    """No profiler: the same null context every time, and no record
    function is made; a ``match`` then runs without one."""

    def refuse(name):
        raise AssertionError(f"record function made for {name}")

    assert profiling.span("tpumatch.match") is profiling.span("tpumatch.run")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert _results(match(TEXT, PAT, device="cpu")) == _want([PAT])
    with profiling.span("tpumatch.match") as s:
        assert s is None


def test_span_under_a_profiler_and_without_the_fast_record(monkeypatch):
    """Under a profiler a span is a record function of its own; a torch
    without ``_RecordFunctionFast`` gets the null context there too, never
    ``record_function``."""
    null = profiling.span("x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("tpumatch.run") is not null
        monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
        assert profiling.span("tpumatch.run") is null
