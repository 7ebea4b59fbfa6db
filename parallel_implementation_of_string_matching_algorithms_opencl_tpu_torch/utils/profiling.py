"""Tracing and timing helpers (counterpart of the JAX package's
``utils/profiling.py``).

The reference wraps ``jax.profiler`` traces, a pipelined wall-clock timer
and XLA's compiled-module cost analysis.  Here:

- ``trace`` records a ``torch.profiler`` trace (CPU, and CUDA where a card
  is present) and exports it as a Chrome/Perfetto JSON file;
- ``span`` names a layer of the port (``tpumatch.*``) in whatever
  ``torch.profiler`` session is recording, on the device trace's clock;
- ``timed`` is the reference's pipelined timer: ``iters`` dispatches, one
  synchronize;
- ``device_stats`` takes ``compiled_stats``'s place with what the card
  measured (XLA's cost analysis has no PyTorch counterpart);
- the card's timers: ``cuda_ms`` (CUDA events around a batch of calls),
  ``host_ms`` (host clock ending in a synchronize), ``kernel_device_ms``
  (one kernel's own device time by name from the profiler),
  ``device_profile`` (device time and events per run) and ``device_busy``
  (the union of a trace's device intervals).  Each of the first four needs
  the card and raises without it, or when ``fn`` returns only CPU tensors:
  they never time the CPU under a device metric's name.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

# A ``cpu_op`` in the profiler's trace: unlike ``record_function``'s
# ``user_annotation``, the profiler does not project it onto the card's
# timeline, so a span never counts as device work or covers an idle gap.
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_NULL = contextlib.nullcontext()


def _activities() -> list:
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def _sync() -> None:
    """Wait for the card when this process has used it; CPU work is done
    when its call returns."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and the
    card's where CUDA is available) and write it to ``log_dir`` (default
    ``tpumatch-trace`` in the temporary directory) as
    ``trace_<pid>_<ns>.json``, which Perfetto and chrome://tracing open.
    Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tpumatch-trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        try:
            yield log_dir
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name: str):
    """A context that records ``name`` (a ``tpumatch.*`` layer name) as a
    host operation of the calling thread while a ``torch.profiler``
    session records, nested in the spans that enclose it: the benchmark's
    traced window, ``trace``, or an operator's own profiler.  With no
    profiler recording it is one shared null context, and nothing is
    recorded."""
    if _RecordFunctionFast is None or not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _RecordFunctionFast(name)


def timed(fn, *args, iters: int = 10, warmup: int = 1):
    """(seconds_per_call, last_output) with pipelined dispatch: ``iters``
    dispatches, one synchronize at the end (of the card, when this process
    has used it), so it measures throughput, not the host's wait per
    call."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    _sync()
    return (time.perf_counter() - t0) / iters, outs[-1]


def _leaves(obj):
    """What ``obj`` holds, walking lists, tuples, dicts and dataclasses."""
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _leaves(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _leaves(x)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    else:
        yield obj


def _nbytes(obj) -> int:
    """Bytes held by the tensors, arrays and byte strings in ``obj``."""
    total = 0
    for x in _leaves(obj):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += x.nbytes
        elif isinstance(x, (bytes, bytearray, memoryview)):
            total += len(x)
    return total


def _card_call(fn, what: str):
    """``fn()`` once, after checking that the card is there, and that the
    call did not return only CPU tensors: a CUDA-only timer never times
    the CPU.  A result with no tensor (a ``MatchResult``) passes."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the card, and CUDA is not available")
    out = fn()
    ts = [x for x in _leaves(out) if isinstance(x, torch.Tensor)]
    if ts and not any(t.is_cuda for t in ts):
        raise ValueError(f"{what} times the card, and fn returned CPU tensors")
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events around the whole batch, after ``warmup`` calls)."""
    _card_call(fn, "cuda_ms")
    for _ in range(warmup - 1):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, passes: int = 3) -> list[float]:
    """Per-pass mean wall time of ``fn()`` in ms (host clock, ending in a
    device synchronize), after one warm call."""
    _card_call(fn, "host_ms")
    torch.cuda.synchronize()
    out = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def kernel_device_ms(fn, runs: int, name: str, wrapper) -> tuple[float, int]:
    """(device ms per launch, launches recorded) of the kernels whose name
    holds ``name`` over ``runs`` calls of ``fn()`` under torch.profiler:
    the kernel's own time, without the host's launch path.  ``wrapper``'s
    launch count must rise by one per call.  The profiler can drop a few
    of the card's activity records, so the time is the mean over the
    launches it recorded, of which there must be at least one and at most
    one per call."""
    _card_call(fn, "kernel_device_ms")
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    assert wrapper.launches - before == runs, (
        f"{name}: {wrapper.launches - before} launches in {runs} calls")
    mine = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    assert 1 <= len(mine) <= runs, f"{name}: {len(mine)} kernels in {runs} calls"
    return sum(e.time_range.elapsed_us() for e in mine) / 1e3 / len(mine), len(mine)


def device_profile(fn, runs: int) -> tuple[float, float, dict]:
    """(device ms per run, device events per run, device ms per run of the
    six event names that take the most) of ``fn()`` under torch.profiler:
    the summed durations of the events that ran on the card (kernels,
    copies, memsets), each counted once."""
    _card_call(fn, "device_profile")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    _busy, summed, events, split = device_busy(prof)
    return summed / runs, events / runs, {k: v / runs for k, v in split.items()}


def device_busy(prof) -> tuple[float, float, int, dict]:
    """(busy ms, summed ms, events, summed ms of the six event names that
    take the most) of the card's events in a torch.profiler trace: busy is
    the union of their intervals, so a copy that overlaps a kernel counts
    once there and twice in the sum.  A trace without device events (the
    CPU's) gives zeros."""
    spans, split = [], collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            split[e.name] += e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3, sum(split.values()), len(spans), dict(split.most_common(6))


def device_stats(fn, *args, runs: int = 5) -> dict:
    """What the card measured over ``runs`` calls of ``fn(*args)`` under
    torch.profiler, after one warm call: the counterpart of the reference's
    ``compiled_stats``, whose XLA cost analysis (flops, bytes accessed,
    transcendentals) PyTorch does not have, so those keys are absent.

    Keys, per run where it says so: ``device`` (the card's name, or
    ``"cpu"``), ``runs``, ``wall_ms`` per run (host clock, ending in a
    synchronize), ``device_ms`` per run (summed device event durations),
    ``device_events`` per run, ``busy_ms`` per run (the union of the device
    events' intervals), ``idle_share`` (1 - busy / wall), ``top_events``
    (device ms per run of the six event names that take the most),
    ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over the runs),
    ``argument_size_bytes`` and ``output_size_bytes`` (the tensors, arrays
    and byte strings in ``args`` and in the last output).  Without a card
    the device numbers are zeros (the trace has no device events), and
    ``idle_share`` and ``peak_bytes`` are None: not measured."""
    cuda = torch.cuda.is_available()
    out = fn(*args)
    _sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            out = fn(*args)
        _sync()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    busy, summed, events, split = device_busy(prof)
    return {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "runs": runs,
        "wall_ms": wall,
        "device_ms": summed / runs,
        "device_events": events / runs,
        "busy_ms": busy / runs,
        "idle_share": 1 - busy / runs / wall if cuda else None,
        "top_events": {k: v / runs for k, v in split.items()},
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "argument_size_bytes": _nbytes(args),
        "output_size_bytes": _nbytes(out),
    }
