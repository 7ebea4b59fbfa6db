"""BENCHMARK.json against the benchmark's contract, and a cell added from
new files alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, manifest  # noqa: E402


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_benchmark_meets_the_contract(bench):
    assert manifest.check(bench) == []


def test_names_units_and_charset(bench):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[kind]:
            assert manifest.NAME.match(item["name"]), item["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert all(ord(c) < 128 for c in json.dumps(m))
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_every_layer_metric_reports_where_its_end_to_end_metric_does(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]]["workloads"], (m["name"], cell)
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], bench)
        assert cell.per_layer and any(
            m["name"] != "setup_s" for m in cell.end_to_end)
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                assert m["name"] in cell.traffic["metrics"]
    broken = json.loads(json.dumps(bench))
    broken["end_to_end"][0]["workloads"].append("bm-dna100m.host")
    assert any("takes no statistic" in e for e in manifest.check(broken))


def test_four_chip_share(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    broken = json.loads(json.dumps(bench))
    broken["workloads"][0]["chips"] = 4
    # one cell on four chips is always allowed, a second is not
    assert not any("4 chips" in e for e in manifest.check(broken))
    broken["workloads"][1]["chips"] = 4
    assert any("4 chips" in e for e in manifest.check(broken))


def test_contract_violations_are_found(bench):
    for edit, word in (
            (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
            (lambda b: b["per_layer"][0].update(moves="setup_s"), "moves"),
            (lambda b: b["per_layer"][0].update(why="x"), "keys"),
            (lambda b: b["configs"][0].update(name="a b"), "name"),
            (lambda b: b["per_layer"][0].update(unit="per second"), "unit"),
            (lambda b: b.update(run_seconds=52), "run_seconds")):
        broken = json.loads(json.dumps(bench))
        edit(broken)
        assert any(word in e for e in manifest.check(broken)), word


def test_a_cell_from_new_files_alone(bench, tmp_path):
    """A new configuration with a corpus of a new kind, a traffic mix with
    a new entry and a new statistic, and a per-layer metric are files and
    entries: nothing that exists is edited, and the cell runs."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    files = tmp_path / "portbench"
    conf = json.loads((files / "configs/bm-dna100m.json").read_text())
    conf.update(name="bm-rna10m", corpus={"kind": "rna", "bytes": 10_000_000})
    conf["patterns"]["pool"] = 2
    (files / "configs/bm-rna10m.json").write_text(json.dumps(conf))
    (files / "corpora/rna.py").write_text(
        "import torch\n"
        "def fill(out, n, g):\n"
        "    c = torch.randint(0, 4, (n,), generator=g, device=out.device)\n"
        "    out[:n] = torch.tensor(list(b'ACGU'), dtype=torch.uint8)[c]\n")
    (files / "entries/twice.py").write_text(
        "from portbench import workload\n"
        "class Entry(workload.Entry):\n"
        "    def query(self, k):\n"
        "        m = self.matcher(k)\n"
        "        m.run(self.text, self.n)\n"
        "        return workload.answers([self.base.make_result(\n"
        "            m.name, m.pattern_bytes, self.n, *m.run(self.text, self.n))])\n")
    (files / "stats/calls_per_s.py").write_text(
        "def value(w):\n    return w['queries'] / w['window_s']\n")
    (files / "traffic/burst.json").write_text(json.dumps(
        {"entry": "twice", "check_sample": 8, "trace_seconds": 1,
         "metrics": {"burst_calls_per_s": "calls_per_s"}}))
    (files / "metrics/events.burst.py").write_text(
        "def read(view):\n    return len(view.events) or None\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "bm-rna10m", "source": "https://example.org/x",
                           "file": "portbench/configs/bm-rna10m.json",
                           "reduced": ["corpus"], "why": "another alphabet"})
    new["workloads"].append({"name": "bm-rna10m.burst", "config": "bm-rna10m",
                             "traffic": "burst", "chips": 1, "why": "a test"})
    new["end_to_end"].insert(0, {"name": "burst_calls_per_s", "unit": "1/s",
                                 "better": "higher", "bound": 0.05,
                                 "source": "host_clock",
                                 "workloads": ["bm-rna10m.burst"]})
    new["per_layer"].append({"name": "events.burst", "unit": "events",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "burst_calls_per_s",
                             "workloads": ["bm-rna10m.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    assert manifest.check(new, tmp_path) == []
    cell = manifest.cell("bm-rna10m.burst", root=tmp_path)
    assert cell.config["corpus"]["bytes"] == 10_000_000
    assert [m["name"] for m in cell.end_to_end] == ["burst_calls_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["events.burst"]
    read = manifest.reader("events.burst", tmp_path)
    assert read(type("V", (), {"events": [1, 2]})()) == 2
    line = harness.run(cell, 2**31 + 5, 0.3, False, device="cpu",
                       n=200_000)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"burst_calls_per_s", "setup_s"}
    assert line["metrics"]["burst_calls_per_s"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_missing_plugin_files_are_found(bench, tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench/stats/p95_ms.py").unlink()
    (tmp_path / "portbench/entries/host.py").unlink()
    (tmp_path / "portbench/corpora/english.py").unlink()
    errors = manifest.check(bench, tmp_path)
    for word in ("no stat file p95_ms", "no entry file",
                 "no corpus file english"):
        assert any(word in e for e in errors), (word, errors)


def test_the_check_fits_with_every_cell(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
