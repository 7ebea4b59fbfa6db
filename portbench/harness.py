"""One run of one cell: set-up, warm-up, a closed loop for the window, the
check against the plain reference, and the result's line.

A closed loop: one caller issues each query when the previous one has
returned its results to the host.  The cell's traffic file names the
entry that makes the queries (``entries/<entry>.py``) and, for each
end-to-end metric, the statistic taken of the window (``stats/<stat>.py``).
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from . import manifest, reference, traces, workload

JAX_NAMES = ("jax", "jaxlib", "flax", workload.PORT[: -len("_torch")])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def jax_loaded() -> list:
    """Modules of JAX or of the JAX package that this process holds,
    compared by whole top-level names."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


class HostProbe:
    """How fast the host ran this process, read around the window: the
    time of a fixed loop of Python and of a tiny device operation's
    launch, before and after, and the share of the window's wall in which
    this process ran on a CPU.  These enter no metric; they tell a run on
    a slow host from a slow run."""

    LOOP = 200_000
    LAUNCHES = 500

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.one = torch.zeros(1, device=dev)

    def speed(self) -> tuple:
        t = time.perf_counter()
        acc = 0
        for i in range(self.LOOP):
            acc += i & 7
        loop_ms = (time.perf_counter() - t) * 1e3
        _sync(self.dev)
        t = time.perf_counter()
        for _ in range(self.LAUNCHES):
            self.one.add_(1)
        _sync(self.dev)
        return loop_ms, (time.perf_counter() - t) / self.LAUNCHES * 1e6

    def start(self) -> None:
        self.before = self.speed()
        self.cpu = time.process_time()

    def stop(self, window_s: float) -> dict:
        cpu = time.process_time() - self.cpu
        after = self.speed()
        return {"loop_ms": [self.before[0], after[0]],
                "launch_us": [self.before[1], after[1]],
                "cpu_share": cpu / window_s if window_s > 0 else None}


def measure(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: float | None = None,
            n: int | None = None, entry: str | None = None) -> dict:
    """Set-up, warm-up and the window: what was measured and kept.
    ``entry`` replaces the traffic's entry (the control); ``n`` serves the
    tests only."""
    t0 = t0 if t0 is not None else time.perf_counter()
    phases = {"start": time.perf_counter() - t0}
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    phases["context"] = time.perf_counter() - t0
    n = n or cell.config["corpus"]["bytes"]
    cls = manifest.plugin("entries", entry or cell.traffic["entry"],
                          cell.root).Entry
    ent = cls(cell.config, seed, dev, n, cell.root)
    _sync(dev)
    phases["corpus"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ent.warm()
    probe = HostProbe(dev)
    probe.start()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    phases["warm"] = setup_s

    traffic = cell.traffic
    seconds = (min(seconds, traffic["trace_seconds"]) if trace else seconds)
    order = workload.Passes(len(ent.items), seed)
    kept = workload.Sample(traffic["check_sample"], seed)
    latency = []
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        *([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
          else [])]) if trace else contextlib.nullcontext())
    # No collection of Python's garbage inside the window: what the port
    # leaves is collected after it.
    gc.collect()
    gc.disable()
    try:
        with prof:
            t_start = now = time.perf_counter()
            deadline = t_start + seconds
            i = 0
            while now < deadline:
                k = order.next(i)
                if trace:
                    with torch.profiler.record_function(traces.QUERY_SPAN):
                        answers = ent.query(k)
                else:
                    answers = ent.query(k)
                done = time.perf_counter()
                latency.append(done - now)
                kept.offer(i, k, answers)
                now, i = done, i + 1
            _sync(dev)
            t_end = time.perf_counter()
    finally:
        gc.enable()
    host = probe.stop(t_end - t_start)

    view = None
    if trace:
        view = traces.from_profile(prof, i, t_end - t_start, n, cell.config)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return dict(entry=ent, setup_s=setup_s, phases=phases, view=view,
                kept=kept.kept, peak=peak, host=host,
                window=dict(queries=i, text_bytes=n, window_s=now - t_start,
                            latency_s=latency))


def check(kept: list, entry) -> dict:
    """Each kept answer against the plain reference: the numbers compared,
    each with its limit (an exact comparison: 0)."""
    refs, wrong = {}, {"wrong_counts": 0, "wrong_offsets": 0,
                       "wrong_overflow_flags": 0}
    cap = entry.cfg.capacity
    for k, answers in kept:
        for j, pat in enumerate(entry.items[k]):
            if pat not in refs:
                refs[pat] = reference.find_all(entry.text, entry.n, pat)
            ref = refs[pat]
            ans = answers[j] if j < len(answers) else None
            if ans is None or ans.pattern != pat:
                for key in wrong:
                    wrong[key] += 1
                continue
            offs = np.asarray(ans.offsets, np.int64)
            wrong["wrong_counts"] += ans.count != len(ref)
            wrong["wrong_offsets"] += not np.array_equal(offs, ref[:cap])
            wrong["wrong_overflow_flags"] += ans.overflow != (len(ref) > cap)
    return {k: {"value": int(v), "limit": 0} for k, v in wrong.items()}


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None, n: int | None = None,
        entry: str | None = None) -> dict:
    """The result's line of one run, as a dict whose last key is
    ``checks``: each number compared with its limit.  Raises SystemExit,
    naming them, where the process holds a module of JAX or of the JAX
    package once everything else is done."""
    out = measure(cell, seed, seconds, trace, device, t0, n, entry)
    ent, view = out["entry"], out["view"]
    ent.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = check(out["kept"], ent)
    correct = bool(out["kept"]) and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = manifest.reader(m["name"], cell.root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        stats = cell.traffic["metrics"]
        for m in cell.end_to_end:
            value = (out["setup_s"] if m["name"] == "setup_s" else
                     manifest.plugin("stats", stats[m["name"]],
                                     cell.root).value(out["window"]))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(out["peak"]),
           "power_limit_w": _power_limit_w() if cuda else None}
    line = {"correct": correct, "attempted": out["window"]["queries"],
            "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        line["breakdown"] = {"device_ops": view.device_ops(),
                             "idle_gaps": view.idle_gaps()}
    line["setup_phases_s"] = out["phases"]
    line["host"] = out["host"]
    line["checked_answers"] = sum(len(a) for _k, a in out["kept"])
    line["checks"] = checks
    loaded = jax_loaded()
    if loaded:
        raise SystemExit(f"portbench: the run loaded {', '.join(loaded)}")
    return line
