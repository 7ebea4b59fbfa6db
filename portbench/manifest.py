"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is an entry of ``workloads``; its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, and each per-layer metric ``<name>`` has its
reader in ``metrics/<name>.py``.  What these files name is code of its
own, found the same way (``plugin``): the entry a traffic mix drives,
``entries/<entry>.py``; the statistic each of its end-to-end metrics
takes of the window, ``stats/<stat>.py``; the generator of a
configuration's corpus, ``corpora/<kind>.py``.  A later cell,
configuration or metric is new files and new entries: nothing here or in
the harness names one.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
# The wall a full check of the largest benchmark may take: 2 + 14 runs a
# cell, each run_seconds + 60 s, 2 x 90 s of compile a cell, 1200 s spare.
CHECK_LIMIT_S, MAX_CELLS = 43200, 24


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: its entry, its configuration and its traffic mix,
    each as read from its file, and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    root: Path = ROOT


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic read from
    their files; KeyError for a cell ``BENCHMARK.json`` does not list."""
    bench = bench if bench is not None else load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=read_json(root / conf["file"]),
        traffic=read_json(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _in_cell(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _in_cell(m, name)),
        root=root,
    )


def plugin_path(kind: str, name: str, root: Path | None = None) -> Path:
    return (root or ROOT) / "portbench" / kind / f"{name}.py"


@functools.cache
def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[2]))),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plugin(kind: str, name: str, root: Path | None = None):
    """The module ``portbench/<kind>/<name>.py``, loaded once."""
    return _load(plugin_path(kind, name, root))


def reader(metric: str, root: Path | None = None):
    """``read(view)`` of ``metrics/<metric>.py``."""
    return plugin("metrics", metric, root).read


def _text(s, what: str, errors: list) -> None:
    if not (isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
            and "\t" not in s):
        errors.append(f"{what}: 1-200 characters on one line, no tab")


def check(bench: dict, root: Path = ROOT) -> list[str]:
    """What in ``bench`` breaks the benchmark's contract; empty when
    nothing does.  Each file a name points to must exist."""
    errors: list[str] = []
    if tuple(bench) != TOP_KEYS:
        errors.append(f"top-level keys {list(bench)} != {list(TOP_KEYS)}")
        return errors
    paths = bench["paths"]
    if not (1 <= len(paths) <= 16) or not all(
            PATH.match(p) and not p.startswith("/") and ".." not in p
            for p in paths):
        errors.append("paths: 1-16 relative directories inside the repo")
    cmd = bench["command"]
    if not (1 <= len(cmd) <= 32) or any(
            w.startswith("/") or ".." in w for w in cmd):
        errors.append("command: at most 32 words, no absolute or .. path")
    for w in cmd:
        _text(w, "command word", errors)
        if "/" in w and not any(w.startswith(p + "/") for p in paths):
            errors.append(f"command names {w}, outside paths")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")
    elif ((2 + 14 * MAX_CELLS) * (rs + 60) + MAX_CELLS * 180 + 1200
          > CHECK_LIMIT_S):
        errors.append("run_seconds: a full check of 24 cells would not fit")

    names = {}
    for kind, keys in (("configs", ("name", "source", "file", "reduced",
                                    "why")),
                       ("workloads", ("name", "config", "traffic", "chips",
                                      "why")),
                       ("end_to_end", ("name", "unit", "better", "bound",
                                       "source")),
                       ("per_layer", ("name", "unit", "better", "source",
                                      "layer", "moves"))):
        items = bench[kind]
        if not items:
            errors.append(f"{kind}: empty")
        for item in items:
            extra = set(item) - set(keys) - {"workloads"}
            if (set(keys) - set(item)) or extra or (
                    "workloads" in item and kind in ("configs", "workloads")):
                errors.append(f"{kind} {item.get('name')}: keys {sorted(item)}")
                continue
            if not NAME.match(item["name"]):
                errors.append(f"{kind}: bad name {item['name']!r}")
            key = "metric" if kind in ("end_to_end", "per_layer") else kind
            if item["name"] in names.setdefault(key, set()):
                errors.append(f"{kind}: {item['name']} twice")
            names[key].add(item["name"])
    if errors:
        return errors
    if not (1 <= len(bench["configs"]) <= 24 and
            1 <= len(bench["workloads"]) <= MAX_CELLS and
            1 <= len(bench["end_to_end"]) <= 16 and
            1 <= len(bench["per_layer"]) <= 128):
        errors.append("too many or too few configs, cells or metrics")

    cells = {w["name"]: w for w in bench["workloads"]}
    used = set()
    for c in bench["configs"]:
        _text(c["source"], f"config {c['name']} source", errors)
        _text(c["why"], f"config {c['name']} why", errors)
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(NAME.match(k) for k in c["reduced"])):
            errors.append(f"config {c['name']}: reduced")
        if not any(c["file"].startswith(p + "/") for p in paths) or not (
                root / c["file"]).is_file():
            errors.append(f"config {c['name']}: file {c['file']}")
    if len({c["file"] for c in bench["configs"]}) != len(bench["configs"]):
        errors.append("two configs share a file")
    confs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        _text(w["why"], f"workload {w['name']} why", errors)
        if not (NAME.match(w["config"]) and NAME.match(w["traffic"])):
            errors.append(f"workload {w['name']}: config or traffic name")
        if w["config"] not in confs:
            errors.append(f"workload {w['name']}: no config {w['config']}")
        used.add(w["config"])
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"workload {w['name']}: pair used twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            errors.append(f"workload {w['name']}: chips must be 1 or 4")
        tfile = root / "portbench" / "traffic" / f"{w['traffic']}.json"
        if not tfile.is_file():
            errors.append(f"workload {w['name']}: no traffic file")
            continue
        traffic = read_json(tfile)
        if not plugin_path("entries", traffic.get("entry", ""), root).is_file():
            errors.append(f"traffic {w['traffic']}: no entry file")
        for stat in traffic.get("metrics", {}).values():
            if not plugin_path("stats", stat, root).is_file():
                errors.append(f"traffic {w['traffic']}: no stat file {stat}")
        conf = next((c for c in bench["configs"]
                     if c["name"] == w["config"]), None)
        if conf and (root / conf["file"]).is_file():
            kind = read_json(root / conf["file"]).get("corpus", {}).get("kind", "")
            if not plugin_path("corpora", kind, root).is_file():
                errors.append(f"config {w['config']}: no corpus file {kind}")
    if confs - used:
        errors.append(f"configs no cell uses: {sorted(confs - used)}")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    if four > max(1, len(cells) // 4):
        errors.append(f"{four} cells on 4 chips: more than 25%")

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        errors.append("end_to_end: no setup_s")
    for m in [*bench["end_to_end"], *bench["per_layer"]]:
        if not UNIT.match(m["unit"]):
            errors.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errors.append(f"metric {m['name']}: better")
        if m["source"] not in SOURCES:
            errors.append(f"metric {m['name']}: source")
        for c in m.get("workloads", ()):
            if c not in cells:
                errors.append(f"metric {m['name']}: no cell {c}")
    for m in bench["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            errors.append(f"metric {m['name']}: end-to-end source")
        if not (isinstance(m["bound"], (int, float))
                and 0.01 <= m["bound"] <= 0.25):
            errors.append(f"metric {m['name']}: bound out of [0.01, 0.25]")
    if "workloads" in e2e.get("setup_s", {}):
        errors.append("setup_s is reported in every cell")
    for m in bench["per_layer"]:
        _text(m["layer"], f"metric {m['name']} layer", errors)
        if m["moves"] not in e2e or m["moves"] == "setup_s":
            errors.append(f"metric {m['name']}: moves {m['moves']!r}")
            continue
        for c in m.get("workloads", cells):
            if not _in_cell(e2e[m["moves"]], c):
                errors.append(f"metric {m['name']}: cell {c} does not "
                              f"report {m['moves']}")
        if not plugin_path("metrics", m["name"], root).is_file():
            errors.append(f"metric {m['name']}: no reader file")
    for c, w in cells.items():
        tfile = root / "portbench" / "traffic" / f"{w['traffic']}.json"
        stats = read_json(tfile).get("metrics", {}) if tfile.is_file() else {}
        for m in bench["end_to_end"]:
            if (m["name"] != "setup_s" and _in_cell(m, c)
                    and m["name"] not in stats):
                errors.append(f"cell {c}: traffic {w['traffic']} takes no "
                              f"statistic for {m['name']}")
        if not any(_in_cell(m, c) for m in bench["end_to_end"]
                   if m["name"] != "setup_s"):
            errors.append(f"cell {c}: no end-to-end metric besides setup_s")
        if not any(_in_cell(m, c) for m in bench["per_layer"]):
            errors.append(f"cell {c}: no per-layer metric")
    if len(json.dumps(bench, indent=2).encode()) > 64 * 1024:
        errors.append("BENCHMARK.json over 64 KiB")
    return errors
