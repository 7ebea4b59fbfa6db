"""What a traced window read: the device's events and the host's activity
from ``torch.profiler``, reduced to what the per-layer readers take.

``View`` is what ``metrics/<name>.py``'s ``read(view)`` gets.  A reader
that finds nothing to read returns None, and the metric is left out.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path

SPAN_PREFIX = "portbench."
QUERY_SPAN = SPAN_PREFIX + "query"
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its namespaces, return type and argument
    list, cut to ``width``; other events' names as they are."""
    if not name.startswith("void "):
        return name[:width]
    for noise in ("void ", "(anonymous namespace)::", "at::native::",
                  "at_cuda_detail::cub::", "(anonymous namespace)"):
        name = name.replace(noise, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


@dataclasses.dataclass
class View:
    """One traced window of one rank.

    ``events``: (name, start_us, end_us) of every device event (kernels,
    copies, memsets, collectives); ``host``: (name, start_us, end_us) of
    the profiled operations of the thread that made the calls; ``queries``: the calls
    completed in the window; ``window_s``: its length on the host clock;
    ``text_bytes``: the text bytes one call scans; ``config``: the cell's
    configuration file."""

    events: list
    host: list
    queries: int
    window_s: float
    text_bytes: int
    config: dict

    def named(self, *parts: str) -> list:
        """Device events whose name holds any of ``parts`` (any case)."""
        low = [p.lower() for p in parts]
        return [e for e in self.events if any(p in e[0].lower() for p in low)]

    def per_query_ms(self, events) -> float | None:
        """Summed device ms of ``events`` per call; None without events."""
        if not events or not self.queries:
            return None
        return sum(hi - lo for _n, lo, hi in events) / 1e3 / self.queries

    def busy_s(self) -> float:
        """Seconds in which some device event ran: the union of the
        events' intervals, so overlapping ones count once."""
        busy, end = 0.0, float("-inf")
        for _n, lo, hi in sorted(self.events, key=lambda e: e[1]):
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        return busy / 1e6

    def idle_share(self) -> float | None:
        if not self.events or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device events that took the most."""
        by = collections.Counter()
        for name, lo, hi in self.events:
            by[short(name)] += (hi - lo) / 1e6
        return [[k, v] for k, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """[host activity, seconds] of the device's idle gaps inside the
        window, each named by the innermost operation that the calling
        thread was running at its middle ("python" where it ran none)."""
        gaps, end = [], None
        for lo, hi in sorted((lo, hi) for _n, lo, hi in self.events):
            if end is not None and lo > end:
                gaps.append(((lo + end) / 2, (lo - end) / 1e6))
            end = hi if end is None else max(end, hi)
        # The calling thread's operations nest, so a stack swept in order
        # of start holds, at any point, the operations running there,
        # innermost on top.
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by, stack, i = collections.Counter(), [], 0
        for mid, secs in sorted(gaps):
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            by[stack[-1][0] if stack else "python"] += secs
        return [[k, v] for k, v in by.most_common(top)]


def from_profile(prof, queries: int, window_s: float, text_bytes: int,
                 config: dict) -> View:
    """``View`` of a finished ``torch.profiler.profile``, read from its raw
    events (``prof.events()`` takes minutes on a window of a million)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events, host = [], []
    for e in prof.profiler.kineto_results.events():
        lo = e.start_ns() / 1e3
        hi = lo + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            # The query span's projection onto the device's timeline is
            # not work the device did.
            if not e.name().startswith(SPAN_PREFIX):
                events.append((e.name(), lo, hi))
        else:
            host.append((e.name(), lo, hi, e.start_thread_id()))
    # The calling thread is the one that ran the harness's query spans.
    calls = [h[3] for h in host if h[0] == QUERY_SPAN]
    thread = calls[0] if calls else None
    host = [h[:3] for h in host if h[3] == thread]
    return View(events=events, host=host, queries=queries, window_s=window_s,
                text_bytes=text_bytes, config=config)
