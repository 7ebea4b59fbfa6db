"""The metric arithmetic: the busy union, the tail over all calls, the
rate over the window, the readers, and the naming of idle gaps."""

import statistics
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import manifest, traces  # noqa: E402


def view(events, host=(), queries=4, window_s=0.001, text_bytes=10**8,
         config=None):
    return traces.View(events=list(events), host=list(host), queries=queries,
                       window_s=window_s, text_bytes=text_bytes,
                       config=config or {"scan_kernels": ["screen_cand_kernel"]})


def test_busy_is_the_union_of_intervals():
    v = view([("k1", 0, 100), ("copy", 50, 150), ("k2", 300, 400),
              ("k3", 310, 320)])
    assert v.busy_s() == pytest.approx(250e-6)
    assert v.idle_share() == pytest.approx(1 - 250e-6 / 0.001)
    assert view([]).idle_share() is None


def test_tail_and_rate_over_every_call():
    lat = [0.001] * 95 + [0.5] * 5
    w = {"queries": 100, "text_bytes": 10**8, "window_s": 4.0, "latency_s": lat}
    rate = manifest.plugin("stats", "rate_GBps").value
    p95 = manifest.plugin("stats", "p95_ms").value
    assert rate(w) == pytest.approx(2.5)
    # the 95th percentile of all 100 calls lies between the two groups
    assert 1 <= p95(w) <= 500
    w["latency_s"] = [0.001 * i for i in range(1, 101)]
    assert p95(w) == pytest.approx(95.05)


def test_readers():
    ev = [("void (anonymous namespace)::screen_cand_kernel<false>(int)", 0, 60),
          ("Memcpy HtoD (Pageable -> Device)", 100, 2100),
          ("void naive_kernel<true>(int)", 2300, 2400)]
    v = view(ev, queries=2)
    read = {m: manifest.reader(m) for m in (
        "h2d_ms.host", "device_events.resident", "device_ms.resident",
        "scan_roofline.resident", "idle_share.resident")}
    assert read["h2d_ms.host"](v) == pytest.approx(1.0)
    assert read["device_events.resident"](v) == 1.5
    assert read["device_ms.resident"](v) == pytest.approx(2160 / 2 / 1e3)
    # 10^8 bytes over 3.35 TB/s is 29.85 us; K1 took 30 us a call
    assert read["scan_roofline.resident"](v) == pytest.approx(
        100 * 1e8 / 3.35e12 / 30e-6)
    empty = view([], queries=0)
    for r in read.values():
        assert r(empty) is None
    assert read["scan_roofline.resident"](view(ev[1:])) is None


def test_idle_gaps_named_by_the_innermost_host_operation():
    ev = [("k", 0, 10), ("k", 20, 30), ("k", 60, 70), ("k", 100, 110)]
    host = [("portbench.query", 0, 200), ("aten::nonzero", 12, 19),
            ("cudaStreamSynchronize", 14, 18), ("aten::item", 40, 65)]
    gaps = dict(view(ev, host).idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert gaps["portbench.query"] == pytest.approx(30e-6)
    assert "python" in dict(view(ev, []).idle_gaps())
    assert sum(dict(view(ev, host).idle_gaps()).values()) == pytest.approx(
        70e-6)


def test_device_ops_top_ten_by_time():
    ev = [(f"void k{i}<int>(float*)", 0, i + 1) for i in range(12)]
    ops = view(ev).device_ops()
    assert len(ops) == 10 and ops[0] == ["k11<int>", pytest.approx(12e-6)]
    assert traces.short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_spread_as_the_contract_takes_it():
    runs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _q2, q3 = statistics.quantiles(runs, n=4)
    assert (q3 - q1) / statistics.median(runs) < 0.05
