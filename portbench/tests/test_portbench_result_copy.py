"""The reader of the port's ``tpumatch.result.copy`` span,
``metrics/result_copy_ms.resident.py``: exact values on hand-made views,
None on a trace without that span (a port that copies results another
way, or a run on the CPU, which copies nothing), without device events or
without queries; and a traced run on the CPU, where ``make_result`` records
its ``tpumatch.result`` and no copy inside it."""

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, manifest, traces  # noqa: E402

NAME = "result_copy_ms.resident"

EVENTS = [("k", 0, 10), ("Memcpy DtoH (Device -> Pinned)", 40, 45)]
HOST = [
    ("portbench.query", 0, 200),
    ("tpumatch.run", 5, 30),
    ("tpumatch.result", 30, 60),
    ("tpumatch.result.copy", 32, 52),
    ("cudaStreamSynchronize", 41, 50),
    ("tpumatch.result", 60, 100),
    ("tpumatch.result.copy", 61, 91),
]


def view(host=HOST, events=EVENTS, queries=1):
    return traces.View(events=list(events), host=list(host), queries=queries,
                       window_s=0.01, text_bytes=10**9, config={})


def read(v):
    return manifest.reader(NAME)(v)


def test_sums_the_copy_spans_a_query():
    # 20 + 30 us of copy spans; the enclosing result spans do not count
    assert read(view()) == pytest.approx(0.050)
    assert read(view(queries=2)) == pytest.approx(0.025)
    assert read(view(host=HOST[:4])) == pytest.approx(0.020)


@pytest.mark.parametrize("case", ["parent", "no_spans", "no_events",
                                  "no_queries"])
def test_none_without_a_copy_span_an_event_or_a_query(case):
    v = {"parent": view([h for h in HOST if h[0] != "tpumatch.result.copy"]),
         "no_spans": view([]),
         "no_events": view(events=[]),
         "no_queries": view(queries=0)}[case]
    assert read(v) is None


def test_traced_cpu_run_records_no_copy(monkeypatch):
    """A traced run of config 2 on the CPU: its results record
    ``tpumatch.result`` and, with nothing to copy, no
    ``tpumatch.result.copy``, so the reader reads nothing even where a
    device event is added."""
    cell = manifest.cell("rk8-en1g.resident")
    conf = {**cell.config, "patterns": {**cell.config["patterns"], "pool": 2}}
    cell = dataclasses.replace(cell, config=conf)
    views = []
    from_profile = traces.from_profile

    def keep(*args, **kwargs):
        views.append(from_profile(*args, **kwargs))
        return views[-1]

    monkeypatch.setattr(traces, "from_profile", keep)
    line = harness.run(cell, 2**31 + 11, 0.3, True, device="cpu", n=4_500_000)
    assert line["correct"] is True
    assert NAME not in line["metrics"]
    (v,) = views
    names = [h[0] for h in v.host]
    assert "tpumatch.result" in names and "tpumatch.result.copy" not in names
    assert read(dataclasses.replace(v, events=[("k", 0.0, 1.0)])) is None
