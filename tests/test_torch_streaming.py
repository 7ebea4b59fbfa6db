"""PyTorch port: streaming (``…_torch/parallel/streaming.py``) on the CPU
against the oracle and the JAX package's ``match_stream``.

It mirrors ``tests/test_streaming.py`` (matches at every chunk seam, the
single-chunk file, resume with a partial journal tail and a manifest
mismatch, overflow kept across resume, drain, multi-pattern journals, KMP
lists) and adds the algorithm-list form, ``capacity=0`` and owned ranges.
Every shared case runs at two geometries:

- ``ref``: the reference tests' 8 KiB chunks with ``pad_multiple=1024``; a
  chunk is shorter than a kernel tile, so every scan takes the plain mask
  route (the spy below checks that no scan kernel ran);
- ``tile``: 128 KiB chunks on 64 KiB tiles (``pallas_chunk_bytes=512``); a
  chunk's owned bytes are whole tiles, and a spy on the scan kernels' plain
  versions checks that the kernel route ran in every chunk.  The JAX side
  runs at ``use_pallas="off"``.

Each port result equals the oracle and the reference (count, offsets,
overflow, algo, n), and the port's manifest and journals equal the
reference's byte for byte.  A last group of cases runs the port alone
against the oracle, where the reference cannot (unaligned ``chunk_bytes``)
or differs by design (``drain=True`` with ``capacity=0``).
"""

import _torch_threads  # noqa: F401

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
    streaming as jstreaming,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    match_stream,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    shift_and,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.streaming import (
    StreamingMatcher,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)


@dataclasses.dataclass(frozen=True)
class Geometry:
    chunk: int
    pcfg: MatchConfig
    jcfg: jconfig.MatchConfig
    kernels: bool  # the chunk's owned bytes are whole kernel tiles

    def configs(self, **kw):
        return self.pcfg.replace(**kw), self.jcfg.replace(**kw)


_BASE = {"capacity": 4096, "verify_capacity": 8192, "pad_multiple": 1024}
GEOMETRIES = {
    "ref": Geometry(8192, MatchConfig(**_BASE), jconfig.MatchConfig(**_BASE),
                    kernels=False),
    "tile": Geometry(
        131072, MatchConfig(pallas_chunk_bytes=512, **_BASE),
        jconfig.MatchConfig(pallas_chunk_bytes=512, use_pallas="off", **_BASE),
        kernels=True),
}

# The scan each unit's run takes on the kernel route, by unit kind.
SCANS = {"boyer_moore": (swar, "screen_cand_bsums_plain"),
         "naive": (swar, "naive_bsums_plain"),
         "kmp": (shift_and, "kmp_bsums_plain"),
         "rabin_karp": (rk_roll, "rk_candidate_bsums_plain"),
         "rabin_karp_multi": (rk_roll, "rk_candidate_pmask_plain")}


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def geo(request):
    return GEOMETRIES[request.param]


@pytest.fixture
def spy(monkeypatch):
    """Counts of calls of the scan kernels' plain versions (the kernel
    route on a CPU tensor)."""
    calls = collections.Counter()
    for mod, fn in SCANS.values():
        def counted(*a, _orig=getattr(mod, fn), _fn=fn, **kw):
            calls[_fn] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    return calls


def check_route(geo, spy, sm) -> None:
    """Tile geometry: each unit's scan ran once per chunk at least (drains
    may add more); reference geometry: no scan kernel ran."""
    if not geo.kernels:
        assert sum(spy.values()) == 0, spy
        return
    need = collections.Counter()
    for u in sm._units:
        kind = "rabin_karp_multi" if u.multi else sm.algos[u.idxs[0]]
        need[SCANS[kind][1]] += sm.last_stats["chunks"]
    for fn, n in need.items():
        assert spy[fn] >= n, (fn, spy[fn], n)


def as_list(r):
    return r if isinstance(r, list) else [r]


def assert_same(got, want, data: bytes) -> None:
    """Port results equal the reference's and the oracle: with overflow,
    the offsets are an ascending subset of the oracle's (each chunk's first
    ``capacity``)."""
    got, want = as_list(got), as_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        oracle = find_all(data, g.pattern)
        assert (g.algo, g.pattern, g.n) == (w.algo, w.pattern, w.n)
        assert g.count == w.count == len(oracle), g.pattern
        assert g.overflow == bool(w.overflow), g.pattern
        assert g.offsets.dtype == np.int64
        assert g.offsets_list() == [int(x) for x in w.offsets], g.pattern
        if g.overflow:
            assert set(g.offsets_list()) <= set(oracle)
            assert g.offsets_list() == sorted(g.offsets_list())
        else:
            assert g.offsets_list() == oracle, g.pattern


def assert_same_files(port_manifest: str, jax_manifest: str, k: int) -> None:
    """The port's manifest and journals equal the reference's, byte for
    byte."""
    def read(p):
        with open(p, "rb") as f:
            return f.read()

    assert read(port_manifest) == read(jax_manifest)
    suffixes = [".offsets"] if k == 1 else [f".offsets.{i}" for i in range(k)]
    for s in suffixes:
        assert read(port_manifest + s) == read(jax_manifest + s), s


def run_both(geo, spy, path, data, pattern, algo="boyer_moore", tmp=None,
             resume=False, drain=False, chunk=None, **cfg):
    """The port's ``StreamingMatcher`` (device="cpu") and the reference's
    ``match_stream`` on the same file and config; checks results, route and
    (with ``tmp``) files.  Returns the port's results."""
    pcfg, jcfg = geo.configs(**cfg)
    chunk = chunk or geo.chunk
    pm = pj = None
    if tmp is not None:
        pm, pj = str(tmp / "port.json"), str(tmp / "jax.json")
    spy.clear()
    sm = StreamingMatcher(pattern, algo, pcfg, chunk, pm, device="cpu")
    got = sm.match_file(path, resume=resume, drain=drain)
    check_route(geo, spy, sm)
    want = jstreaming.match_stream(path, pattern, algo, jcfg, chunk, pj,
                                   resume=resume, drain=drain)
    assert_same(got, want, data)
    if tmp is not None:
        assert_same_files(pm, pj, sm.k)
    return got


def interrupted(base, stop_at: int):
    """``base`` (the port's or the reference's StreamingMatcher) that stops
    reading before chunk ``stop_at``, as a crash would."""
    class Interrupted(base):
        def _iter_chunks(self, *args):
            for item in super()._iter_chunks(*args):
                if item[0] >= stop_at:
                    return
                yield item

    return Interrupted


def interrupt_both(geo, path, pattern, algo, tmp, stop_at: int, drain=False,
                   **cfg):
    """Run both packages with manifests until chunk ``stop_at``; returns
    (port manifest path, reference manifest path)."""
    pcfg, jcfg = geo.configs(**cfg)
    pm, pj = str(tmp / "port.json"), str(tmp / "jax.json")
    interrupted(StreamingMatcher, stop_at)(
        pattern, algo, pcfg, geo.chunk, pm, device="cpu").match_file(
            path, drain=drain)
    interrupted(jstreaming.StreamingMatcher, stop_at)(
        pattern, algo, jcfg, geo.chunk, pj).match_file(path, drain=drain)
    assert_same_files(pm, pj, 1 if not isinstance(pattern, list) else len(pattern))
    return pm, pj


@pytest.fixture(scope="module")
def corpus(geo, tmp_path_factory):
    C = geo.chunk
    d = tmp_path_factory.mktemp("stream")
    data = bytearray(gen_english(C * 5 + 137, seed=21))
    pat = b"XSEAMX"
    # Matches straddling every chunk seam at all phases, plus interior.
    for k in range(1, 5):
        for phase in range(-len(pat), 1, 2):
            p = k * C + phase
            data[p : p + len(pat)] = pat
    data[100 : 100 + len(pat)] = pat
    data[len(data) - len(pat) :] = pat  # match at EOF
    path = d / "corpus.bin"
    path.write_bytes(bytes(data))
    return str(path), bytes(data), pat


@pytest.fixture(scope="module")
def dense_corpus(geo, tmp_path_factory):
    """Chunk 1, and the chunk 1/2 seam, far past a capacity of 16 for
    ``aa``."""
    C = geo.chunk
    d = tmp_path_factory.mktemp("dense")
    data = bytearray(gen_english(C * 4 + 77, seed=5))
    data[C + 100 : C + 800] = b"a" * 700
    data[2 * C - 50 : 2 * C + 50] = b"a" * 100  # ownership splits mid-run
    path = d / "dense.bin"
    path.write_bytes(bytes(data))
    return str(path), bytes(data)


@pytest.mark.parametrize("algo", ["naive", "rabin_karp", "kmp", "boyer_moore"])
def test_stream_exact(geo, spy, corpus, algo):
    path, data, pat = corpus
    assert len(find_all(data, pat)) >= 6
    run_both(geo, spy, path, data, pat, algo)


def test_stream_single_chunk_file(geo, spy, corpus, tmp_path):
    path, data, pat = corpus
    small = tmp_path / "small.bin"
    small.write_bytes(data[:300])
    run_both(geo, spy, str(small), data[:300], pat, "naive", tmp=tmp_path)


def test_stream_resume(geo, spy, corpus, tmp_path):
    """Interrupted after 2 chunks, a partial record appended to the
    journal (a crash mid-append): resume truncates it and finishes; a
    different pattern invalidates the manifest."""
    path, data, pat = corpus
    pm, pj = interrupt_both(geo, path, pat, "kmp", tmp_path, 2)
    man = json.load(open(pm))
    assert man["next_chunk"] == 2 and "offsets" not in man
    assert man["journal_entries"] == len(
        [x for x in find_all(data, pat) if x < 2 * geo.chunk])
    for p in (pm, pj):
        with open(p + ".offsets", "ab") as f:
            f.write(b"\x01\x02\x03")
    r = run_both(geo, spy, path, data, pat, "kmp", tmp=tmp_path, resume=True)
    assert r.count == len(find_all(data, pat))
    run_both(geo, spy, path, data, b"XSEAMY", "kmp", tmp=tmp_path, resume=True)


def test_stream_resume_preserves_overflow(geo, spy, tmp_path):
    """Chunk 0 overflows capacity 16, the run stops after it, and the
    resumed run (whose chunks do not overflow) still reports overflow."""
    C = geo.chunk
    dense = tmp_path / "dense.bin"
    data = b"a" * 601 + b"x" * (3 * C - 601)
    dense.write_bytes(data)
    pm, _ = interrupt_both(geo, str(dense), b"aa", "naive", tmp_path, 1,
                           capacity=16)
    assert json.load(open(pm))["overflow"] is True
    r = run_both(geo, spy, str(dense), data, b"aa", "naive", tmp=tmp_path,
                 resume=True, capacity=16)
    assert r.count == 600 and r.overflow and len(r.offsets) == 16


def test_stream_drain_overflow_chunk(geo, spy, dense_corpus, tmp_path):
    """drain=True returns every offset, with overflow False, across a seam
    inside a dense run; without it the same stream flags the truncation."""
    path, data = dense_corpus
    want = find_all(data, b"aa")
    assert len(want) > 700
    r = run_both(geo, spy, path, data, b"aa", "naive", drain=True, capacity=16)
    assert r.offsets_list() == want and not r.overflow
    r0 = run_both(geo, spy, path, data, b"aa", "naive", tmp=tmp_path,
                  capacity=16)
    assert r0.count == len(want) and r0.overflow


@pytest.mark.parametrize("algo", ["rabin_karp", "kmp", "boyer_moore"])
def test_stream_drain_all_algos(geo, spy, dense_corpus, algo):
    path, data = dense_corpus
    r = run_both(geo, spy, path, data, b"aab", algo, drain=True, capacity=4)
    assert r.offsets_list() == find_all(data, b"aab") and not r.overflow


def test_stream_drain_multi_pattern_journal(geo, spy, dense_corpus, tmp_path):
    """'aa' (overflows; a member of the Rabin-Karp group, drained by its
    own single-pattern matcher) and 'ab' (fits) in one pass, journaled."""
    path, data = dense_corpus
    rs = run_both(geo, spy, path, data, [b"aa", b"ab"], "rabin_karp",
                  tmp=tmp_path, drain=True, capacity=16)
    assert all(not r.overflow for r in rs)


def test_stream_drain_resume(geo, spy, dense_corpus, tmp_path):
    """Resume across a drained chunk splices without duplicates."""
    path, data = dense_corpus
    pm, _ = interrupt_both(geo, path, b"aa", "naive", tmp_path, 2, drain=True,
                           capacity=16)
    man = json.load(open(pm))
    assert man["next_chunk"] == 2 and man["overflow"] is False
    assert man["count"] < len(find_all(data, b"aa"))
    r = run_both(geo, spy, path, data, b"aa", "naive", tmp=tmp_path,
                 resume=True, drain=True, capacity=16)
    assert not r.overflow


def test_stream_multi_pattern(geo, spy, corpus, tmp_path):
    """Equal-length Rabin-Karp patterns share one hash pass, mixed lengths
    group by length; per-pattern ownership holds at the seams (a 4-byte
    pattern starting right at a seam lies in the previous chunk's 6-byte
    halo); a warm manifest resumes to the same results."""
    path, data, pat = corpus
    C = geo.chunk
    pats = [pat, b"the ", b"e qu", bytes(data[C - 2 : C + 2]),
            bytes(data[2 * C : 2 * C + 4])]
    cfg = {"capacity": 1 << 15, "verify_capacity": 1 << 15}
    rs = run_both(geo, spy, path, data, pats, "rabin_karp", tmp=tmp_path, **cfg)
    assert len(json.load(open(tmp_path / "port.json"))["count"]) == len(pats)
    rs2 = run_both(geo, spy, path, data, pats, "rabin_karp", tmp=tmp_path,
                   resume=True, **cfg)
    assert [r.offsets_list() for r in rs2] == [r.offsets_list() for r in rs]


def test_stream_multi_pattern_kmp(geo, spy, corpus):
    path, data, pat = corpus
    run_both(geo, spy, path, data, [pat, b"q"], "kmp")


def test_stream_algorithm_list(geo, spy, corpus, tmp_path):
    """One pattern under a list of algorithms: one result per algorithm,
    the chunk read once (BASELINE config 5's form)."""
    path, data, pat = corpus
    algos = ["boyer_moore", "naive", "kmp", "rabin_karp"]
    rs = run_both(geo, spy, path, data, pat, algos, tmp=tmp_path)
    assert [r.algo for r in rs] == [f"{a}@stream" for a in algos]
    with pytest.raises(ValueError):
        StreamingMatcher([pat], algos, device="cpu")


def test_stream_count_only(geo, spy, corpus, tmp_path):
    """capacity=0 streams count-only: exact counts, no offsets, overflow
    where there is a match."""
    path, data, _ = corpus
    rs = run_both(geo, spy, path, data, [b"the ", b"ZZZ"], "boyer_moore",
                  tmp=tmp_path, capacity=0)
    assert [(len(r.offsets), r.overflow) for r in rs] == [(0, True), (0, False)]
    assert rs[0].count == len(find_all(data, b"the "))


def test_stream_owned_range_halves(geo, spy, corpus):
    """Owned ranges [0, mid) and [mid, size): absolute offsets, and the two
    halves concatenated equal the whole, in both packages."""
    path, data, pat = corpus
    pcfg, jcfg = geo.configs()
    mid = 2 * geo.chunk + 3  # a planted match straddles it
    for algo in ("rabin_karp", "boyer_moore"):
        pats = [pat, b"the "]
        halves = []
        for lo, hi in ((0, mid), (mid, len(data))):
            spy.clear()
            sm = StreamingMatcher(pats, algo, pcfg, geo.chunk, device="cpu")
            got = sm.match_file(path, start=lo, stop=hi)
            check_route(geo, spy, sm)
            want = jstreaming.StreamingMatcher(pats, algo, jcfg,
                                               geo.chunk).match_file(
                path, start=lo, stop=hi)
            for g, w in zip(got, want):
                assert g.count == w.count
                assert g.offsets_list() == [int(x) for x in w.offsets]
                assert all(lo <= x < hi for x in g.offsets_list())
            halves.append(got)
        for i, p in enumerate(pats):
            want = find_all(data, p)
            assert (halves[0][i].offsets_list() + halves[1][i].offsets_list()
                    == want)
            assert halves[0][i].count + halves[1][i].count == len(want)
    with pytest.raises(ValueError, match="bad owned range"):
        StreamingMatcher(pat, device="cpu").match_file(path, start=5, stop=4)


# -- the port alone, against the oracle --------------------------------------


@pytest.mark.parametrize("pat", [b"the ", bytes(gen_english(4000, seed=3))],
                         ids=["m4", "m4000"])
def test_unaligned_chunk_bytes(tmp_path, pat):
    """chunk_bytes=10000 rounds up to 12288 (a multiple of 4096) and the
    device chunk is sized from the rounded value (the reference sizes it
    from 10000 and raises in its repack or its read)."""
    C = 12288
    data = bytearray(gen_english(100_000, seed=8))
    for off in (C - len(pat) // 2, 2 * C - 1, 5 * C - len(pat), 99_999 - len(pat)):
        data[off : off + len(pat)] = pat
    path = tmp_path / "u.bin"
    path.write_bytes(bytes(data))
    for algo in ("boyer_moore", "rabin_karp"):
        sm = StreamingMatcher(pat, algo, MatchConfig(pad_multiple=1024), 10000,
                              device="cpu")
        assert sm.chunk_bytes == C
        assert sm._dev_len == C + -(-(len(pat) - 1) // 4096) * 4096
        r = sm.match_file(str(path))
        assert r.offsets_list() == find_all(bytes(data), pat) and r.count >= 4


@pytest.mark.parametrize("algo", ["naive", "rabin_karp", "kmp", "boyer_moore"])
def test_nul_pattern_never_matches_the_zero_tail(tmp_path, algo):
    """A pattern ending in NUL bytes whose head ends the file must not
    match the chunk's zeroed tail (n is the chunk's valid bytes, never its
    device length); its real occurrences are found."""
    pat = b"ab\x00\x00"
    data = bytearray(gen_english(3 * 8192 + 50, seed=9))
    data[8190:8194] = pat  # across the first seam
    data[-2:] = b"ab"
    path = tmp_path / "nul.bin"
    path.write_bytes(bytes(data))
    for chunk in (8192, 3 * 8192 + 48):  # EOF mid-chunk and right after its end
        r = match_stream(str(path), pat, algo, MatchConfig(pad_multiple=1024),
                         chunk, device="cpu")
        assert r.offsets_list() == find_all(bytes(data), pat) == [8190]


def test_drain_with_count_only_raises_before_any_read(tmp_path):
    path = tmp_path / "t.bin"
    path.write_bytes(b"aaaa" * 100)

    class NoRead(StreamingMatcher):
        def _iter_chunks(self, *args):
            raise AssertionError("read a chunk")

    sm = NoRead(b"aa", "naive", MatchConfig(capacity=0), 8192, device="cpu")
    with pytest.raises(ValueError, match="capacity=0 is count-only"):
        sm.match_file(str(path), drain=True)
    with pytest.raises(ValueError, match="capacity=0 is count-only"):
        match_stream(str(path), "aa", config=MatchConfig(capacity=0),
                     drain=True, device="cpu")
    r = StreamingMatcher(b"aa", "naive", MatchConfig(capacity=0),
                         device="cpu").match_file(str(path))
    assert (r.count, len(r.offsets), r.overflow) == (399, 0, True)


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    path = tmp_path / "t.bin"
    path.write_bytes(b"some text")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        match_stream(str(path), b"text")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingMatcher(b"text")
    assert match_stream(str(path), "text", device="cpu").offsets_list() == [5]


def test_journal_lost_restarts_from_chunk_zero(tmp_path):
    """A manifest whose journal is gone restarts from chunk 0; offsets stay
    int64 past 2**31 in the journal format."""
    data = bytearray(gen_english(5 * 8192, seed=4))
    path = tmp_path / "j.bin"
    path.write_bytes(bytes(data))
    manifest = str(tmp_path / "m.json")
    cfg = MatchConfig(pad_multiple=1024)
    interrupted(StreamingMatcher, 3)(b"the ", "naive", cfg, 8192, manifest,
                                     device="cpu").match_file(str(path))
    os.remove(manifest + ".offsets")
    r = match_stream(str(path), b"the ", "naive", cfg, 8192, manifest,
                     resume=True, device="cpu")
    assert r.offsets_list() == find_all(bytes(data), b"the ")
    assert json.load(open(manifest))["next_chunk"] == 5
    sm = StreamingMatcher(b"the ", device="cpu", manifest_path=manifest)
    sm._journal_reset(0)
    sm._journal_append(np.array([5, 1 << 33], np.int64))
    assert np.fromfile(manifest + ".offsets", "<i8").tolist() == [5, 1 << 33]


def test_empty_file_and_empty_range(tmp_path):
    """An empty file streams one empty chunk (the reference's memmap of it
    raises); an empty owned range finds nothing."""
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    for algo in ("naive", ["kmp", "rabin_karp"]):
        rs = match_stream(str(empty), b"ab", algo, device="cpu")
        for r in (rs if isinstance(rs, list) else [rs]):
            assert (r.count, r.offsets_list(), r.overflow, r.n) == (0, [], False, 0)
    full = tmp_path / "t.bin"
    full.write_bytes(b"abab" * 10)
    r = StreamingMatcher(b"ab", device="cpu").match_file(str(full), start=6, stop=6)
    assert (r.count, r.offsets_list()) == (0, [])
