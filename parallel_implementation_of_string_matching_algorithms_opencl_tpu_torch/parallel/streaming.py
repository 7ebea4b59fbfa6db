"""Streaming matcher: a file of any size in fixed-shape chunks
(counterpart of the JAX ``parallel/streaming.py``).

A chunk owns the match starts in its first ``chunk_bytes`` positions and
reads ``max_m - 1`` bytes past them as lookahead, so a match straddling a
chunk seam is found exactly once.  Every chunk has one device shape,
``_dev_len`` bytes: the owned bytes rounded up to lcm(``pad_multiple``,
4096), plus the halo rounded up to the same multiple.  The file is read once
for all patterns; each scan unit, one matcher per pattern or one
``RabinKarpMultiMatcher`` per group of two or more equal-length Rabin-Karp
patterns, runs ``run`` over the same chunk buffer.

Geometry.  At the default 64 MiB chunk and ``pallas_chunk_bytes`` 16384
the owned bytes are a whole number of every kernel tile (512 KiB for the
SWAR kernels K1-K3, 2 MiB for the KMP and Rabin-Karp kernels): the kernels
cover the owned bytes and the plain tail route only the halo.  Any other
``chunk_bytes`` is accepted and exact; a chunk that is not a tile multiple
runs its remainder on the plain route.

Pipeline on a CUDA device.  ``run`` waits on the host inside a call (its
counts are Python ints and its extraction sizes outputs from the data), so
scans cannot be queued ahead; the overlap comes from the copy path:

- a reader thread fills one of two pinned host buffers from a memmap slice,
  one chunk ahead, refilling a buffer only after its last copy completed;
- the main thread starts the copy of chunk k+1 into one of two device
  buffers on a side stream before it runs chunk k; the copy waits for the
  run that last read that buffer, and the run waits for its chunk's copy;
- each chunk's offsets are packed, in caller order, into one int64 tensor
  (a ``torch.cat``, never a view of the chunk buffer) and copied to a
  pinned host tensor without blocking;
- one resolver thread waits for that copy, then journals, drains and
  writes the manifest in chunk order.

On ``device="cpu"`` there is no pinning and no stream: a chunk's host
buffer is the text ``run`` reads.  The reference's word repack and
``ship_words`` have no counterpart: ``text.view(torch.int32)`` is free.

Resume: a JSON manifest records the next chunk and the per-pattern counts,
journal lengths and overflow flags; offsets go to append-only per-pattern
journals of little-endian int64.  Both are byte-compatible with the
reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from ..models.base import MatchResult, resolve_device
from ..models.multi import RabinKarpMultiMatcher
from ..models.registry import get_matcher
from ..utils.config import DEFAULT_CONFIG, MatchConfig

DEFAULT_CHUNK_BYTES = 64 << 20


@dataclasses.dataclass
class _Unit:
    """One scan unit: a single-pattern matcher or a shared-hash-pass
    multi-pattern group (equal lengths).  ``idxs`` maps the unit's result
    rows back to caller pattern order."""

    matcher: object
    m: int
    idxs: list[int]
    multi: bool


@dataclasses.dataclass
class _Chunk:
    """A chunk read into host buffer ``slot``, its text on the device
    (device buffer ``dslot`` on CUDA, the host buffer itself on the CPU)
    and the event of its copy (None on the CPU)."""

    ci: int
    start: int
    owned_len: int
    valid_n: int
    slot: int
    dslot: int
    text: torch.Tensor
    copied: object


@dataclasses.dataclass
class _PendingPacked:
    """One chunk's results on their way to the resolver: per caller
    pattern its count, overflow flag and number of offsets, and the offsets
    of every pattern concatenated (chunk-relative int64, on the host; on
    CUDA a pinned tensor whose copy completes at ``ready``)."""

    chunk_idx: int
    start: int
    counts: list[int]
    overflows: list[bool]
    lengths: list[int]
    offsets: torch.Tensor
    ready: object


class _Stopped(Exception):
    """The reader was told to stop."""


class _ChunkFeed:
    """A file's chunks on their way to the scan.

    A reader thread fills two host buffers (pinned on CUDA) through
    ``chunks(buffers)`` (``StreamingMatcher._iter_chunks``), refilling one
    only once it is released: on CUDA when the copy out of it completed, on
    the CPU when the chunk that is its text was packed.  On CUDA ``next``
    copies the chunk into one of two device buffers on a side stream,
    after the run that last read that buffer.  The caller takes the text
    with ``text`` (the compute stream then waits for the copy) and calls
    ``release`` once the chunk's run and pack are queued."""

    def __init__(self, chunks, dev_len: int, device: torch.device,
                 stats: dict):
        self.cuda = device.type == "cuda"
        self.device, self.stats = device, stats
        self.hosts = [torch.empty(dev_len, dtype=torch.uint8,
                                  pin_memory=self.cuda) for _ in range(2)]
        self.host_np = [h.numpy() for h in self.hosts]
        if self.cuda:
            self.devs = [torch.empty(dev_len, dtype=torch.uint8, device=device)
                         for _ in range(2)]
            self.copy_stream = torch.cuda.Stream(device=device)
            self.compute = torch.cuda.current_stream(device)
        self.run_done: list = [None, None]
        self.shipped = 0
        self.free: queue.Queue = queue.Queue()  # (host slot, its last copy)
        for s in range(2):
            self.free.put((s, None))
        self.ready: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._read, args=(chunks,),
                                       daemon=True)
        self.thread.start()

    def _read(self, chunks) -> None:
        slot, waited = [None], [0.0]

        def next_buffer():
            t0 = time.perf_counter()
            s, copied = self.free.get()
            if s is None:
                raise _Stopped
            if copied is not None:
                copied.synchronize()
            waited[0] += time.perf_counter() - t0
            slot[0] = s
            return self.host_np[s]

        try:
            it = chunks(next_buffer)
            while True:
                t0, waited[0] = time.perf_counter(), 0.0
                item = next(it, None)
                self.stats["reader_s"] += time.perf_counter() - t0 - waited[0]
                if item is None:
                    break
                self.ready.put((*item[:4], slot[0]))
        except _Stopped:
            return
        except Exception as e:  # re-raised in the main thread
            self.ready.put(e)
            return
        self.ready.put(None)

    def next(self) -> _Chunk | None:
        """The next chunk (None at the end), its copy started on CUDA."""
        t0 = time.perf_counter()
        item = self.ready.get()
        self.stats["read_s"] += time.perf_counter() - t0
        if isinstance(item, Exception):
            raise item
        if item is None:
            return None
        slot, d = item[4], self.shipped % 2
        self.shipped += 1
        if not self.cuda:
            return _Chunk(*item, d, torch.from_numpy(self.host_np[slot]), None)
        with torch.cuda.stream(self.copy_stream):
            if self.run_done[d] is not None:
                self.copy_stream.wait_event(self.run_done[d])
            self.devs[d].copy_(self.hosts[slot], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        self.free.put((slot, copied))
        return _Chunk(*item, d, self.devs[d], copied)

    def text(self, c: _Chunk) -> torch.Tensor:
        """The chunk's text for the compute stream, after its copy."""
        if c.copied is not None:
            self.compute.wait_event(c.copied)
        return c.text

    def release(self, c: _Chunk) -> None:
        """Called once the chunk's run and pack are queued."""
        if self.cuda:
            self.run_done[c.dslot] = torch.cuda.Event()
            self.run_done[c.dslot].record(self.compute)
        else:
            self.free.put((c.slot, None))

    def close(self) -> None:
        self.free.put((None, None))
        self.thread.join()
        if self.cuda:
            torch.cuda.synchronize(self.device)


class StreamingMatcher:
    """Match one or many patterns over a file of any size."""

    def __init__(
        self,
        pattern,
        algo="boyer_moore",
        config: MatchConfig = DEFAULT_CONFIG,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        manifest_path: str | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # Result slots: one per pattern (algo a str), or, with algo a list,
        # one per algorithm over one shared pattern: the chunk is read and
        # shipped once and every algorithm scans the same buffer.
        if isinstance(algo, (list, tuple)):
            if isinstance(pattern, (list, tuple)):
                raise ValueError(
                    "pass a list of patterns OR a list of algorithms"
                )
            self.algos = [get_matcher(a).name for a in algo]
            self.patterns = [bytes(pattern)] * len(self.algos)
            self._single = False
        elif isinstance(pattern, (list, tuple)):
            self.patterns = [bytes(p) for p in pattern]
            self.algos = [get_matcher(algo).name] * len(self.patterns)
            self._single = False
        else:
            self.patterns = [bytes(pattern)]
            self.algos = [get_matcher(algo).name]
            self._single = True
        if not self.patterns or any(len(p) == 0 for p in self.patterns):
            raise ValueError("empty pattern")
        self.k = len(self.patterns)
        self.algo = ";".join(dict.fromkeys(self.algos))  # manifest identity
        self.config = config
        self.m = max(len(p) for p in self.patterns)  # sets the halo
        self.last_stats: dict = {}

        # Scan units: equal-length groups share one Rabin-Karp hash pass;
        # everything else is one matcher per pattern.
        self._units: list[_Unit] = []
        by_len: dict[int, list[int]] = {}
        for i, p in enumerate(self.patterns):
            if self.algos[i] == "rabin_karp":
                by_len.setdefault(len(p), []).append(i)
        unit_specs = [idxs for idxs in by_len.values() if len(idxs) > 1]
        grouped = {i for idxs in unit_specs for i in idxs}
        unit_specs += [[i] for i in range(self.k) if i not in grouped]
        for idxs in unit_specs:
            if len(idxs) > 1:
                mm = RabinKarpMultiMatcher([self.patterns[i] for i in idxs],
                                           config, self.device)
            else:
                mm = get_matcher(self.algos[idxs[0]])(
                    self.patterns[idxs[0]], config, self.device)
            self._units.append(_Unit(matcher=mm, m=mm.m, idxs=list(idxs),
                                     multi=len(idxs) > 1))

        # Chunks are whole multiples of lcm(pad_multiple, 4096) (4096 bytes
        # = one 1024-word row); an unaligned size is rounded up.  The
        # device length is sized from the rounded value.
        pm = int(np.lcm(config.pad_multiple, 4096))
        if chunk_bytes <= 0:
            raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
        self.chunk_bytes = -(-chunk_bytes // pm) * pm
        self._drain_matchers: dict = {}  # per pattern, built on first drain
        # Chunks resolved but not yet consumed (the resolver's queue bound).
        self.pipeline_depth = 2
        halo = self.m - 1
        self._dev_len = self.chunk_bytes + -(-max(halo, 1) // pm) * pm
        self.manifest_path = manifest_path

    @property
    def matcher(self):
        return self._units[0].matcher

    # -- chunk iteration ---------------------------------------------------

    def _iter_chunks(self, path: str, start_chunk: int,
                     range_start: int = 0, range_stop: int | None = None,
                     buffers=None):
        """Yield (chunk_idx, start, owned_len, valid_n, uint8[_dev_len]).

        ``[range_start, range_stop)`` is the owned byte range (default: the
        whole file).  A chunk reads ``owned_len + max_m - 1`` bytes,
        clamped to the file, past ``range_stop`` too for the last chunk,
        and zeroes the rest of its buffer.  ``buffers()`` gives the buffer
        to read each chunk into (default: a new array per chunk)."""
        size = os.path.getsize(path)
        if range_stop is None:
            range_stop = size
        owned_total = max(0, range_stop - range_start)
        n_chunks = max(1, -(-owned_total // self.chunk_bytes))
        mm = (np.memmap(path, dtype=np.uint8, mode="r") if size
              else np.empty(0, np.uint8))
        try:
            for ci in range(start_chunk, n_chunks):
                start = range_start + ci * self.chunk_bytes
                owned_len = min(self.chunk_bytes, range_stop - start)
                stop = min(start + owned_len + self.m - 1, size)
                buf = (buffers() if buffers is not None
                       else np.empty(self._dev_len, np.uint8))
                view = mm[start:stop]
                buf[: len(view)] = view
                buf[len(view) :] = 0
                yield ci, start, owned_len, len(view), buf
        finally:
            del mm

    # -- manifest + offset journals -----------------------------------------
    #
    # The manifest stays O(1) per chunk (identity, cursor, counts); offsets
    # go to append-only per-pattern journals of little-endian int64, each
    # sorted by construction (chunks complete in file order).  The manifest
    # is written after the journal appends and records the durable entry
    # counts; resume truncates any partial tail past them.

    def _journal_path_i(self, i: int) -> str | None:
        if not self.manifest_path:
            return None
        if self.k == 1:
            return self.manifest_path + ".offsets"
        return f"{self.manifest_path}.offsets.{i}"

    def _journal_append(self, offs: np.ndarray, i: int = 0) -> None:
        with open(self._journal_path_i(i), "ab") as f:
            np.asarray(offs, dtype="<i8").tofile(f)

    def _journal_reset(self, entries: int, i: int = 0) -> None:
        """Truncate journal ``i`` to exactly ``entries`` records (0 =
        fresh)."""
        jp = self._journal_path_i(i)
        if not os.path.exists(jp):
            entries = 0
        with open(jp, "ab"):
            pass  # ensure existence
        with open(jp, "r+b") as f:
            f.truncate(8 * entries)

    def _pattern_hex(self) -> str:
        return ";".join(p.hex() for p in self.patterns)

    def _load_manifest(self, path: str, rng: tuple[int, int]):
        if not self.manifest_path or not os.path.exists(self.manifest_path):
            return None
        with open(self.manifest_path) as f:
            man = json.load(f)
        size = os.path.getsize(path)
        if (
            man.get("path") != os.path.abspath(path)
            or man.get("chunk_bytes") != self.chunk_bytes
            or man.get("algo") != self.algo
            or man.get("pattern_hex") != self._pattern_hex()
            or tuple(man.get("range", (0, size))) != rng
            or "journal_entries" not in man
            or "overflow" not in man
        ):
            return None
        return man

    def _save_manifest(self, path: str, rng: tuple[int, int],
                       next_chunk: int, counts, journal_entries, overflow):
        """``counts``/``journal_entries``/``overflow``: int/bool for k == 1,
        lists otherwise."""
        if not self.manifest_path:
            return
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "path": os.path.abspath(path),
                    "chunk_bytes": self.chunk_bytes,
                    "algo": self.algo,
                    "pattern_hex": self._pattern_hex(),
                    "range": list(rng),
                    "next_chunk": next_chunk,
                    "count": counts,
                    "journal_entries": journal_entries,
                    "overflow": overflow,
                },
                f,
            )
        os.replace(tmp, self.manifest_path)

    def _restore(self, path: str, rng: tuple[int, int], resume: bool):
        """(start_chunk, totals, journal_entries, overflowed) to continue
        from, with the journals truncated to match."""
        k = self.k
        start_chunk, totals = 0, [0] * k
        journal_entries, overflowed = [0] * k, [False] * k
        man = self._load_manifest(path, rng) if resume else None
        if man:
            start_chunk = man["next_chunk"]
            totals = [int(x) for x in np.atleast_1d(man["count"])]
            journal_entries = [int(x) for x in
                               np.atleast_1d(man["journal_entries"])]
            # A resumed run must not report a truncated journal as complete.
            overflowed = [bool(x) for x in np.atleast_1d(man["overflow"])]
        if self.manifest_path is not None:
            if start_chunk and not all(
                os.path.exists(self._journal_path_i(i)) for i in range(k)
            ):
                # A journal was lost: its offsets are gone, start over.
                start_chunk, totals = 0, [0] * k
                overflowed = [False] * k
            if not start_chunk:
                journal_entries = [0] * k
            for i in range(k):
                self._journal_reset(journal_entries[i], i)
        return start_chunk, totals, journal_entries, overflowed

    # -- main loop ---------------------------------------------------------

    def _pack_outputs(self, chunk: _Chunk, unit_outs) -> _PendingPacked:
        """One chunk's ``run`` results in caller pattern order: counts,
        overflow flags and offset lengths on the host, and every pattern's
        offsets in one int64 tensor, copied to the host without blocking
        (one device-to-host copy per chunk)."""
        k = self.k
        counts, overflows, offs = [0] * k, [False] * k, [None] * k
        for u, out in zip(self._units, unit_outs):
            for gi, (c, o, v) in zip(u.idxs, out if u.multi else [out]):
                counts[gi], offs[gi], overflows[gi] = int(c), o, bool(v)
        flat = torch.cat(offs).to(torch.int64)  # a copy, never a view
        ready = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=torch.int64, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            flat = host
        return _PendingPacked(chunk.ci, chunk.start, counts, overflows,
                              [o.numel() for o in offs], flat, ready)

    def _drain_slot(self, path: str, i: int, start: int, owned_len: int,
                    est: int, size: int) -> np.ndarray:
        """Every offset pattern ``i`` owns in chunk ``[start,
        start + owned_len)``: the chunk's bytes are read again from the file
        and extracted by the pattern's own matcher's windowed
        ``extract_range``, with the ownership the scan used, so the drained
        offsets splice into the journal without duplicates.  ``est`` is
        the chunk's exact count (quantised to a power of two for the window
        sizing); the drain must find exactly that many."""
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        try:
            hi = min(start + owned_len + len(self.patterns[i]) - 1, size)
            arr = np.array(mm[start:hi])
        finally:
            del mm
        matcher = self._drain_matchers.get(i)
        if matcher is None:
            u = next(u for u in self._units if i in u.idxs)
            if u.multi:
                matcher = get_matcher(self.algos[i])(
                    self.patterns[i], self.config, self.device)
            else:
                matcher = u.matcher
            self._drain_matchers[i] = matcher
        est_q = 1 << max(0, int(est) - 1).bit_length()
        offs = matcher.extract_range(arr, 0, owned_len, est_q)
        if len(offs) != est:
            raise AssertionError(
                f"streaming drain mismatch: chunk@{start} pattern {i} "
                f"scan counted {est} but drain extracted {len(offs)}"
            )
        return offs.astype(np.int64) + start

    def match_file(self, path: str, resume: bool = False,
                   start: int = 0, stop: int | None = None,
                   drain: bool = False):
        """MatchResult (single pattern) or list[MatchResult] in caller
        pattern order.

        ``[start, stop)`` restricts owned match starts to that byte range
        (default: the whole file); reads extend ``max_m - 1`` bytes past
        ``stop`` for lookahead.  Offsets are absolute file offsets, so
        results of disjoint ranges merge by concatenation.

        ``drain=True`` returns every offset even when a (chunk, pattern)
        slot exceeds ``config.capacity``: the chunk's owned window is read
        again and extracted by windows (``_drain_slot``), in chunk order,
        so journals stay sorted and complete and ``overflow`` stays False.
        It raises ValueError for ``capacity=0`` (count-only) before any
        read.  Counts are exact either way.
        """
        if drain and self.config.capacity == 0:
            raise ValueError("drain=True needs capacity >= 1; capacity=0 is "
                             "count-only")
        size = os.path.getsize(path)
        if stop is None:
            stop = size
        if not (0 <= start <= stop <= size):
            raise ValueError(
                f"bad owned range [{start}, {stop}) for file of {size} bytes"
            )
        rng = (start, stop)
        k = self.k
        start_chunk, totals, journal_entries, overflowed = self._restore(
            path, rng, resume)
        use_journal = self.manifest_path is not None
        parts: list[list[np.ndarray]] = [[] for _ in range(k)]
        stats = {"read_s": 0.0, "reader_s": 0.0, "dispatch_s": 0.0,
                 "resolve_s": 0.0, "resolve_host_s": 0.0,
                 "enqueue_wait_s": 0.0, "chunks": 0, "drain_s": 0.0,
                 "drained_slots": 0}

        def resolve(p: _PendingPacked) -> None:
            # The wait covers the chunk's copy, scans and pack: device
            # time, not resolve cost; resolve_host_s is the host work.
            if p.ready is not None:
                p.ready.synchronize()
            t_host = time.perf_counter()
            flat, pos = p.offsets.numpy(), 0
            for i in range(k):
                c = p.counts[i]
                kept = flat[pos : pos + p.lengths[i]] + p.start  # a copy
                pos += p.lengths[i]
                totals[i] += c
                ovf = p.overflows[i] or c > len(kept)
                if ovf and drain:
                    t_d = time.perf_counter()
                    owned_len = min(self.chunk_bytes, stop - p.start)
                    kept = self._drain_slot(path, i, p.start, owned_len, c,
                                            size)
                    stats["drain_s"] += time.perf_counter() - t_d
                    stats["drained_slots"] += 1
                    ovf = False
                overflowed[i] |= ovf
                if use_journal:
                    self._journal_append(kept, i)
                    journal_entries[i] += len(kept)
                else:
                    parts[i].append(kept)
            self._save_manifest(
                path, rng, p.chunk_idx + 1,
                totals[0] if k == 1 else totals,
                journal_entries[0] if k == 1 else journal_entries,
                overflowed[0] if k == 1 else overflowed,
            )
            stats["resolve_host_s"] += time.perf_counter() - t_host

        # The resolver consumes each chunk (a wait on its copy) and journals
        # it in chunk order on ONE thread fed by a bounded queue, while the
        # main thread ships and scans the next chunks.  Totals, journals and
        # the manifest are touched only by the resolver until the join.
        rq: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        rerr: list = []

        def resolver() -> None:
            try:
                with _on(self.device):
                    while True:
                        p = rq.get()
                        if p is None:
                            return
                        t0 = time.perf_counter()
                        resolve(p)
                        stats["resolve_s"] += time.perf_counter() - t0
            except Exception as e:  # re-raised in the main thread
                rerr.append(e)
                while rq.get() is not None:  # drain so puts never block
                    pass

        rthread = threading.Thread(target=resolver, daemon=True)
        t_all = time.perf_counter()
        rthread.start()
        feed = None
        try:
            with _on(self.device):
                feed = _ChunkFeed(
                    lambda buffers: self._iter_chunks(path, start_chunk, start,
                                                      stop, buffers),
                    self._dev_len, self.device, stats)
                cur = feed.next()
                while cur is not None and not rerr:
                    stats["chunks"] += 1
                    nxt = feed.next()  # its copy overlaps this chunk's scan
                    t0 = time.perf_counter()
                    text = feed.text(cur)
                    # A chunk owns starts in [0, owned_len): per-unit
                    # validity n_eff = owned_len + m_u - 1 (never the device
                    # length) makes run's own p <= n - m limit coincide with
                    # ownership, so the chunk merge is duplicate-free per
                    # pattern whatever the lengths (the halo uses max_m).
                    outs = [u.matcher.run(text, min(cur.valid_n,
                                                    cur.owned_len + u.m - 1))
                            for u in self._units]
                    pending = self._pack_outputs(cur, outs)
                    feed.release(cur)
                    stats["dispatch_s"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    rq.put(pending)
                    stats["enqueue_wait_s"] += time.perf_counter() - t0
                    cur = nxt
        finally:
            rq.put(None)
            rthread.join()
            if feed is not None:
                feed.close()
        if rerr:
            raise rerr[0]
        stats["wall_s"] = time.perf_counter() - t_all
        self.last_stats = stats

        # Journal order is chunk-major ascending, i.e. already sorted.
        results = []
        for i in range(k):
            if use_journal:
                offs = np.fromfile(self._journal_path_i(i), dtype="<i8")
            else:
                offs = (np.concatenate(parts[i]).astype(np.int64) if parts[i]
                        else np.empty(0, np.int64))
            results.append(
                MatchResult(
                    algo=f"{self.algos[i]}@stream",
                    pattern=self.patterns[i],
                    n=size,
                    count=totals[i],
                    offsets=offs,
                    overflow=overflowed[i],
                )
            )
        return results[0] if self._single else results


def _on(device: torch.device):
    """``torch.cuda.device(device)`` on CUDA; nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def match_stream(
    path: str,
    pattern,
    algo="boyer_moore",
    config: MatchConfig | None = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    manifest_path: str | None = None,
    resume: bool = False,
    drain: bool = False,
    device="cuda",
):
    """Stream the file at ``path`` (see ``StreamingMatcher``).  ``pattern``
    may be bytes or str, or a list of them: a list streams the file once and
    returns a list of MatchResult in input order, as does a list of
    algorithms for one pattern.  ``drain=True`` returns every offset even
    past a chunk's capacity.  ``device`` defaults to ``"cuda"`` and raises
    when CUDA is absent; ``device="cpu"`` runs the plain versions."""
    def coerce(p):
        return p.encode("utf-8") if isinstance(p, str) else bytes(p)

    if isinstance(pattern, (list, tuple)):
        pattern = [coerce(p) for p in pattern]
    else:
        pattern = coerce(pattern)
    sm = StreamingMatcher(
        pattern,
        algo=algo,
        config=config or DEFAULT_CONFIG,
        chunk_bytes=chunk_bytes,
        manifest_path=manifest_path,
        device=device,
    )
    return sm.match_file(path, resume=resume, drain=drain)
