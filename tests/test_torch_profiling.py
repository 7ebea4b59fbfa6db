"""PyTorch port: ``…_torch/utils/profiling.py`` on the CPU.

``timed`` and ``device_stats`` run here (``timed`` as ``tests/test_aux.py``
checks the reference's: a positive time and the function's output); the
card's timers moved from ``chip_smoke.py`` raise here and never time the
CPU.  Their runs on the card are in ``tests/test_torch_cuda.py``.
"""

import _torch_threads  # noqa: F401

import functools
import json
import types

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import match
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
    profiling,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)

TEXT = gen_english(20_000, seed=7)
PAT = b"quick brown"
STATS_KEYS = {"device", "runs", "wall_ms", "device_ms", "device_events", "busy_ms",
              "idle_share", "top_events", "peak_bytes", "argument_size_bytes",
              "output_size_bytes"}


def test_timed_on_match_and_on_a_tensor_function():
    secs, out = profiling.timed(functools.partial(match, device="cpu"), TEXT, PAT,
                                iters=3)
    assert secs > 0 and out.offsets_list() == find_all(TEXT, PAT)
    x = torch.arange(1024.0)
    secs, out = profiling.timed(lambda x: (x * 2 + 1).sum(), x, iters=3)
    assert secs > 0 and float(out) == float((np.arange(1024.0) * 2 + 1).sum())


def test_device_stats_keys_on_the_cpu():
    """Without a card: no device events, so zeros, and None where nothing
    was measured; no XLA cost keys."""
    stats = profiling.device_stats(functools.partial(match, device="cpu"), TEXT, PAT,
                                   runs=2)
    assert set(stats) == STATS_KEYS
    assert stats["device"] == "cpu" and stats["runs"] == 2 and stats["wall_ms"] > 0
    assert stats["device_ms"] == stats["device_events"] == stats["busy_ms"] == 0
    assert stats["top_events"] == {}
    assert stats["idle_share"] is None and stats["peak_bytes"] is None
    assert stats["argument_size_bytes"] == len(TEXT) + len(PAT)
    want = len(find_all(TEXT, PAT))
    assert stats["output_size_bytes"] == 8 * want + len(PAT)  # int64 offsets, pattern
    x = torch.zeros(256, dtype=torch.int32)
    stats = profiling.device_stats(lambda t: (t + 1, t.sum()), x, runs=1)
    assert (stats["argument_size_bytes"], stats["output_size_bytes"]) == (1024, 1024 + 8)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        match(TEXT, PAT, device="cpu")
    assert d == str(tmp_path)
    (path,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(path.read_text())


CARD_TIMERS = {
    "cuda_ms": lambda fn: profiling.cuda_ms(fn, 2),
    "host_ms": lambda fn: profiling.host_ms(fn, 2),
    "kernel_device_ms": lambda fn: profiling.kernel_device_ms(
        fn, 2, "kernel", types.SimpleNamespace(launches=0)),
    "device_profile": lambda fn: profiling.device_profile(fn, 2),
}


@pytest.mark.parametrize("timer", list(CARD_TIMERS))
def test_card_timers_raise_without_cuda(timer, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CARD_TIMERS[timer](lambda: calls.append(1) or torch.ones(4))
    assert calls == []  # nothing ran, nothing was timed


@pytest.mark.parametrize("timer", list(CARD_TIMERS))
def test_card_timers_raise_on_cpu_tensors(timer, monkeypatch):
    """With a card, a function whose output is only CPU tensors is refused
    after its first call, before any device clock or synchronize."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    with pytest.raises(ValueError, match="CPU tensors"):
        CARD_TIMERS[timer](lambda: calls.append(1) or (torch.ones(4), [torch.zeros(2)]))
    assert calls == [1]


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _event(name, start, end, cuda=True):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, time_range=_Range(start, end))


def test_device_busy_is_the_union_of_device_intervals():
    prof = types.SimpleNamespace(events=lambda: [
        _event("k", 0, 1000), _event("copy", 500, 1500), _event("k", 3000, 3500),
        _event("host", 0, 9000, cuda=False)])
    busy, summed, events, split = profiling.device_busy(prof)
    assert (busy, summed, events) == (2.0, 2.5, 3)
    assert split == {"k": 1.5, "copy": 1.0}
    assert profiling.device_busy(types.SimpleNamespace(events=lambda: [])) == (0.0, 0, 0, {})


def test_chip_smoke_keeps_the_moved_timers():
    """``chip_smoke.py`` takes the timers from the package under the same
    names, which ``kernel_ab.py`` reads from it."""
    import chip_smoke
    import kernel_ab

    for name in ("cuda_ms", "host_ms", "kernel_device_ms", "device_profile",
                 "device_busy"):
        assert getattr(chip_smoke, name) is getattr(profiling, name)
    assert kernel_ab.cs is chip_smoke
