"""Whole runs on the CPU at small sizes: the shape of the result's line,
the control, and the faults the check must catch, each planted under the
timed path.  The look for a card is skipped (``harness.run`` is called
with ``device="cpu"``); everything after it runs."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, manifest, workload  # noqa: E402

N = 1_500_000


def small(name: str, pool: int | None = None):
    cell = manifest.cell(name)
    if pool:
        conf = json.loads(json.dumps(cell.config))
        conf["patterns"]["pool"] = pool
        cell = dataclasses.replace(cell, config=conf)
    return cell


def run(name, entry=None, n=N, seconds=0.3, trace=False, pool=None):
    return harness.run(small(name, pool), 2**31 + 99, seconds, trace,
                       device="cpu", n=n, entry=entry)


def test_line_shape_and_order():
    line = run("bm-dna100m.resident", pool=4)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"resident_GBps", "resident_p95_ms",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["device"]["platform"] == "cpu"
    assert {"count", "kind", "memory_peak_bytes"} <= set(line["device"])
    host = line["host"]
    assert host["loop_ms"][0] > 0 and host["launch_us"][1] > 0
    assert host["cpu_share"] > 0
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_shape():
    line = run("bm-dna100m.host", trace=True, pool=4)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: every device reader finds nothing
    assert line["metrics"] == {}


@pytest.mark.parametrize("name", ["bm-dna100m.resident", "rk8-en1g.resident",
                                  "bm-dna100m.host"])
def test_sound_runs_are_correct(name):
    line = run(name, pool=4)
    assert line["correct"] is True, line["checks"]
    assert line["checked_answers"] >= 1


@pytest.mark.parametrize("name", ["bm-dna100m.resident", "rk8-en1g.resident",
                                  "bm-dna100m.host"])
def test_the_control_is_not_correct(name):
    line = run(name, entry="control", pool=4)
    assert line["correct"] is False
    assert line["checks"]["wrong_counts"]["value"] > 0


# The faults, each planted in the port under the timed path.

def _alter_an_answer(monkeypatch):
    base = workload.port_module("models.base")
    real = base.make_result

    def make_result(algo, pattern, n, count, offsets, overflow):
        offsets = offsets.clone()
        if offsets.numel():
            offsets[0] += 1
        return real(algo, pattern, n, count, offsets, overflow)

    monkeypatch.setattr(base, "make_result", make_result)


def _alter_a_count(monkeypatch):
    base = workload.port_module("models.base")
    real = base.Matcher.run
    monkeypatch.setattr(base.Matcher, "run",
                        lambda self, t, n: (lambda c, o, v: (c + 1, o, v))(
                            *real(self, t, n)))


def _leave_out_half_the_patterns(monkeypatch):
    multi = workload.port_module("models.multi")
    real = multi.RabinKarpMultiMatcher.run

    def run_half(self, text, n):
        out = real(self, text, n)
        half = len(out) // 2
        empty = (0, torch.full_like(out[0][1], -1), False)
        return out[:half] + [empty] * (len(out) - half)

    monkeypatch.setattr(multi.RabinKarpMultiMatcher, "run", run_half)


@pytest.mark.parametrize("name,fault", [
    ("bm-dna100m.resident", _alter_an_answer),
    ("bm-dna100m.resident", _alter_a_count),
    ("bm-dna100m.host", _alter_an_answer),
    ("bm-dna100m.host", _alter_a_count),
    ("rk8-en1g.resident", _alter_an_answer),
    ("rk8-en1g.resident", _leave_out_half_the_patterns),
])
def test_a_fault_under_the_timed_path_is_caught(name, fault, monkeypatch):
    assert run(name, pool=4)["correct"] is True
    fault(monkeypatch)
    line = run(name, pool=4)
    assert line["correct"] is False, line["checks"]


def test_run_refuses_without_the_devices_a_cell_asks_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "bm-dna100m.resident", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "bm-dna100m.resident", "--seed", "5", "--seconds",
                          "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
