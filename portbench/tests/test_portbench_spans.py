"""The readers of the port's ``tpumatch.*`` spans (``source:
program_span``): exact values on hand-made views with overlapping and
nested spans, idle gaps inside and outside ``tpumatch.extract`` and waits
inside and outside ``tpumatch.run``; None on a trace without spans, as
a port without them leaves it, or without device events, as a run without
a card leaves it; and a traced run on the CPU, where the spans reach the
readers through ``traces.from_profile``."""

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, manifest, traces  # noqa: E402

READERS = ("extract_idle_ms.resident", "run_syncs.resident",
           "rescans.resident", "pad_ms.host")

# Device busy over [0, 10], [30, 50] (two overlapping events), [100, 120].
EVENTS = [("k", 0, 10), ("k", 30, 40), ("copy", 35, 50), ("k", 100, 120)]
HOST = [
    ("portbench.query", 0, 200),
    ("cudaDeviceSynchronize", 2, 4),        # before the first run span
    ("tpumatch.run", 5, 150),
    ("tpumatch.run", 6, 7),                 # nested in the first
    ("tpumatch.extract", 20, 60),
    ("tpumatch.extract", 25, 45),           # nested
    ("tpumatch.rescan", 26, 44),
    ("cudaStreamSynchronize", 40, 42),      # inside run
    ("tpumatch.extract", 55, 110),          # overlaps the first
    ("cudaMemcpyAsync", 70, 80),            # inside run, not a wait
    ("cudaEventSynchronize", 148, 156),     # midpoint 152: after the run
    ("cudaStreamSynchronize", 160, 170),    # midpoint 165: in the second
    ("tpumatch.run", 165, 190),
    ("tpumatch.result", 190, 195),
    ("tpumatch.stage.pad", 200, 1700),
    ("tpumatch.stage", 199, 4100),
    ("tpumatch.stage.pad", 3000, 4000),
]


def view(host=HOST, events=EVENTS, queries=2):
    return traces.View(events=list(events), host=list(host), queries=queries,
                       window_s=0.01, text_bytes=10**8, config={})


def read(name, v):
    return manifest.reader(name)(v)


def test_extract_idle_is_the_span_union_less_the_busy_union():
    # extract spans' union [20, 110]: 90 us, of which the card ran
    # [30, 50] and [100, 110]; the gaps [10, 20] and [120, 200] lie
    # outside it.  60 us over 2 queries.
    assert read("extract_idle_ms.resident", view()) == pytest.approx(0.030)
    # a device interval that spans two extract spans counts in both
    host = [("tpumatch.extract", 0, 10), ("tpumatch.extract", 20, 30)]
    v = view(host, [("k", 5, 25)], queries=1)
    assert read("extract_idle_ms.resident", v) == pytest.approx(0.010)
    assert read("extract_idle_ms.resident", view(
        [("tpumatch.run", 0, 5)])) == 0.0
    # a device event far from the one extract span: all of it is idle
    v = view([("tpumatch.extract", 0, 40)], [("k", 500, 510)], queries=4)
    assert read("extract_idle_ms.resident", v) == pytest.approx(0.010)


def test_run_syncs_counts_waits_whose_midpoint_lies_in_a_run():
    # the wait at 40-42 and the one centred on 165; not the one before,
    # the one after, nor the copy
    assert read("run_syncs.resident", view()) == pytest.approx(1.0)
    assert read("run_syncs.resident", view(queries=1)) == pytest.approx(2.0)


def test_rescans_and_pad():
    assert read("rescans.resident", view()) == pytest.approx(0.5)
    # 1500 + 1000 us of pad over 2 calls; the enclosing stage is not pad
    assert read("pad_ms.host", view()) == pytest.approx(1.25)
    assert read("pad_ms.host", view(queries=5)) == pytest.approx(0.5)


@pytest.mark.parametrize("name", READERS)
def test_none_without_port_spans(name):
    parent = [h for h in HOST if not h[0].startswith("tpumatch.")]
    assert read(name, view(parent)) is None
    assert read(name, view([])) is None
    assert read(name, view(queries=0)) is None
    assert read(name, view(events=[])) is None


def test_the_benchmark_holds_the_span_metrics():
    bench = manifest.load()
    assert manifest.check(bench) == []
    spans = {m["name"]: m for m in bench["per_layer"]
             if m["source"] == "program_span"}
    assert set(spans) == set(READERS)
    for cell in ("bm-dna100m.resident", "rk8-en1g.resident",
                 "bm-dna100m.host"):
        mine = {m["name"] for m in manifest.cell(cell).per_layer}
        assert {n for n in READERS if cell in spans[n]["workloads"]} <= mine


@pytest.mark.parametrize("name", ["rk8-en1g.resident", "bm-dna100m.host"])
def test_traced_cpu_run_reads_the_port_spans(name, monkeypatch):
    """A traced run on the CPU: the port's spans reach the view on the
    calling thread.  With no card there are no device events, so every
    reader leaves its metric out of the line; the same view with one
    device event added is read."""
    cell = manifest.cell(name)
    conf = {**cell.config, "patterns": {**cell.config["patterns"], "pool": 2}}
    cell = dataclasses.replace(cell, config=conf)
    views = []
    from_profile = traces.from_profile

    def keep(*args, **kwargs):
        views.append(from_profile(*args, **kwargs))
        return views[-1]

    monkeypatch.setattr(traces, "from_profile", keep)
    # config 2's text fills two Rabin-Karp tiles, so its kernel route runs
    n = 4_500_000 if cell.config.get("multi") else 1_500_000
    line = harness.run(cell, 2**31 + 7, 0.3, True, device="cpu", n=n)
    assert line["correct"] is True
    spans = {m["name"] for m in cell.per_layer if m["source"] == "program_span"}
    assert spans and not spans & set(line["metrics"])
    (v,) = views
    assert not v.events
    names = {h[0] for h in v.host}
    assert {"tpumatch.run", "tpumatch.extract", "tpumatch.result"} <= names
    if name == "bm-dna100m.host":
        assert {"tpumatch.match", "tpumatch.stage.pad"} <= names
    card = dataclasses.replace(v, events=[("k", 0.0, 1.0)])
    got = {n: read(n, card) for n in spans}
    assert all(x is not None and x >= 0 for x in got.values())
    if name == "bm-dna100m.host":
        assert got["pad_ms.host"] > 0
    else:
        # one device event of a microsecond: nearly all of extraction idles
        assert got["extract_idle_ms.resident"] > 0
        assert got["run_syncs.resident"] == 0
