"""PyTorch port: ``match_multihost`` and ``match_multihost_streaming``
(``…_torch/parallel/multihost.py``) on two gloo ranks, mirroring
``tests/test_multihost.py``.

One cluster of 2 ranks, this file run as a script once per rank (the group
made by the port's own ``initialize_cluster`` on ``device="cpu"``), runs
every case and writes one JSON file per rank; the tests read the records
through a module fixture.  Matches are planted at the file's start and end,
inside each slice, at chunk seams and straddling the slice boundary.

- ``match_multihost`` (whole slices, and drained) is held against the
  oracle;
- ``match_multihost_streaming`` against the JAX package's own
  ``StreamingMatcher(..., manifest_path + f".h{pid}").match_file(path,
  start=, stop=)`` run in the test process at ``host_slice_bounds(...,
  align=chunk)`` for each slice: the merged results, and each rank's manifest and journals
  byte for byte.  That covers the four algorithms, a pattern list, a drain,
  ``gather_offsets=False`` and a resume after the first chunk;
- ``allgather_i64`` and ``allgather_ragged_i64`` keep values >= 2**40, and
  a ragged gather with an empty row.

The JAX package is imported only inside the tests that compute the
reference.
"""

import _torch_threads  # noqa: F401

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    match_multihost,
    match_multihost_streaming,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel import (
    multihost,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel import (
    streaming as pstreaming,
)

WORLD = 2
# tests/_multihost_worker.py's config.
CFG = {"capacity": 4096, "pad_multiple": 64}
CHUNK = 8192
BIG = [0, 1, 2**31 - 1, 2**31, 2**33 + 7, 2**40, 2**40 + 3, 99_999_999_999,
       2**62 + 5, -1]


@dataclasses.dataclass(frozen=True)
class Case:
    text: bytes
    pattern: object  # bytes, or a list of bytes
    algo: str
    stream: bool = False
    cfg: dict = dataclasses.field(default_factory=dict)
    drain: bool = False
    gather_offsets: bool = True
    resume: bool = False


def _letters(seed: int, n: int, lo: int = 97, hi: int = 101) -> bytearray:
    rng = np.random.default_rng(seed)
    return bytearray(rng.integers(lo, hi, size=n, dtype=np.uint8).tobytes())


def _plant(data: bytearray, pat: bytes, at) -> bytes:
    for p in at:
        data[p : p + len(pat)] = pat
    return bytes(data)


def _whole_text():
    # tests/test_multihost.py:91: host 0 owns [0, 10000).
    return _plant(_letters(13, 20000), b"XSEAMX",
                  (0, 4321, 10000 - 3, 10006, 17000, 20000 - 6))


def _long_text():
    rng = np.random.default_rng(29)
    data = bytearray(rng.integers(97, 123, size=3000, dtype=np.uint8).tobytes())
    pat = bytes(rng.integers(65, 91, size=2000, dtype=np.uint8).tobytes())
    data[500:2500] = pat
    return bytes(data), pat


def _drain_text():
    data = _letters(17, 8000)
    data[100:700] = b"a" * 600
    data[4000 - 1 : 4000 + 1] = b"aa"
    data[6000:6040] = b"a" * 40
    return bytes(data)


def _stream_text():
    size = 9 * CHUNK + 1234
    seam = 4 * CHUNK  # host_slice_bounds(size, 0, _, 2, align=CHUNK)
    return _plant(_letters(41, size), b"XSEAMX",
                  (0, CHUNK - 3, 2 * CHUNK + 100, seam - 3, seam + CHUNK - 3,
                   7 * CHUNK + 57, size - 6))


def _stream_multi_text():
    size = 6 * CHUNK + 777
    data = _letters(43, size)
    for p in (100, 3 * CHUNK - 3, size - 6):
        data[p : p + 6] = b"XSEAMX"
    for p in (50, CHUNK - 1, 4 * CHUNK - 1, 5 * CHUNK + 9):
        data[p : p + 2] = b"QZ"
    return bytes(data)


def _stream_drain_text():
    size = 6 * CHUNK + 555
    seam = 3 * CHUNK
    data = _letters(47, size)
    data[100:700] = b"a" * 600
    data[seam - 50 : seam + 50] = b"a" * 100
    data[4 * CHUNK + 9 : 4 * CHUNK + 209] = b"a" * 200
    return bytes(data)


CASES = {
    **{f"whole-{a}": (lambda a=a: Case(_whole_text(), b"XSEAMX", a))
       for a in ("naive", "kmp", "boyer_moore")},
    "whole-longer-than-a-slice": lambda: Case(*_long_text(), "boyer_moore"),
    "whole-drain": lambda: Case(_drain_text(), b"aa", "naive",
                                cfg={"capacity": 16}, drain=True),
    **{f"stream-{a}": (lambda a=a: Case(_stream_text(), b"XSEAMX", a,
                                        stream=True))
       for a in ("naive", "kmp", "boyer_moore", "rabin_karp")},
    "stream-list": lambda: Case(_stream_multi_text(), [b"XSEAMX", b"QZ"],
                                "kmp", stream=True),
    "stream-drain": lambda: Case(_stream_drain_text(), b"aa", "naive",
                                 stream=True, cfg={"capacity": 16},
                                 drain=True),
    "stream-local-offsets": lambda: Case(_stream_text(), b"XSEAMX",
                                         "boyer_moore", stream=True,
                                         gather_offsets=False),
    "stream-resume": lambda: Case(_stream_multi_text(), [b"XSEAMX", b"QZ"],
                                  "rabin_karp", stream=True, resume=True),
}


# -- the ranks ---------------------------------------------------------------


def _results(res) -> list:
    return [{"algo": r.algo, "count": r.count, "offsets": r.offsets_list(),
             "overflow": r.overflow, "n": r.n,
             "int64": r.offsets.dtype == np.int64}
            for r in (res if isinstance(res, list) else [res])]


def _first_chunk_only(orig):
    def stopped(self, *args, **kw):
        for item in orig(self, *args, **kw):
            if item[0] >= 1:
                return
            yield item
    return stopped


def _port_case(name: str, c: Case, out_dir: str, topo: dict) -> dict:
    path = os.path.join(out_dir, f"{name}.bin")
    cfg = MatchConfig(**{**CFG, **c.cfg})
    cluster = {"coordinator_address": topo["coordinator"],
               "num_processes": WORLD, "process_id": topo["process_id"]}
    if not c.stream:
        return {"results": _results(match_multihost(
            path, c.pattern, algo=c.algo, config=cfg, drain=c.drain,
            device="cpu", **cluster))}

    def stream(resume=False):
        return match_multihost_streaming(
            path, c.pattern, algo=c.algo, config=cfg, chunk_bytes=CHUNK,
            manifest_path=os.path.join(out_dir, f"{name}.man"),
            resume=resume, gather_offsets=c.gather_offsets, drain=c.drain,
            device="cpu", **cluster)

    rec = {}
    if c.resume:
        orig = pstreaming.StreamingMatcher._iter_chunks
        pstreaming.StreamingMatcher._iter_chunks = _first_chunk_only(orig)
        try:
            stream()
        finally:
            pstreaming.StreamingMatcher._iter_chunks = orig
        with open(os.path.join(out_dir, f"{name}.man.h{topo['process_id']}")) as f:
            rec["stopped_at"] = json.load(f)["next_chunk"]
    rec["results"] = _results(stream(resume=c.resume))
    return rec


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from _torch_ranks import write_record

    torch.set_num_threads(1)
    coordinator = f"127.0.0.1:{port}"
    topo = multihost.initialize_cluster(coordinator, world, rank, device="cpu")
    try:
        # A second call finds the group and leaves it as it is.
        assert multihost.initialize_cluster(coordinator, world, rank,
                                            device="cpu") == topo
        record = {"topology": topo, "backend": dist.get_backend(),
                  "cases": {}}
        topo = {**topo, "coordinator": coordinator}
        for name, make in CASES.items():
            record["cases"][name] = _port_case(name, make(), out_dir, topo)
        mesh = multihost.make_data_mesh(device="cpu")
        mine = np.array(BIG, np.int64) + rank
        record["allgather"] = multihost.allgather_i64(mine, mesh).tolist()
        record["allgather_2d"] = multihost.allgather_i64(
            mine[:6].reshape(3, 2), mesh).tolist()
        ragged = (np.empty(0, np.int64) if rank == 0
                  else np.array(BIG[:-1], np.int64) + 2**40)
        record["ragged"] = multihost.allgather_ragged_i64(ragged, mesh).tolist()
        record["ragged_empty"] = multihost.allgather_ragged_i64(
            np.empty(0, np.int64), mesh).tolist()
        write_record(out_dir, rank, record)
    finally:
        dist.destroy_process_group()


# -- the tests ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from _torch_ranks import run_ranks

    out_dir = tmp_path_factory.mktemp("multihost_ranks")
    for name, make in CASES.items():
        (out_dir / f"{name}.bin").write_bytes(make().text)
    return out_dir, run_ranks(os.path.abspath(__file__), WORLD, out_dir)


def test_ranks_form_one_gloo_group(cluster):
    _out, records = cluster
    for r, rec in enumerate(records):
        assert rec["topology"] == {"process_id": r, "process_count": WORLD,
                                   "local_devices": 1,
                                   "global_devices": WORLD}
        assert rec["backend"] == "gloo"


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("whole-")])
def test_match_multihost_equals_the_oracle(name, cluster):
    _out, records = cluster
    c = CASES[name]()
    want = find_all(c.text, c.pattern)
    assert want
    for rec in records:
        (got,) = rec["cases"][name]["results"]
        assert got["count"] == len(want)
        assert got["offsets"] == want and got["int64"]
        assert not got["overflow"]
        assert got["algo"] == f"{c.algo}@hosts{WORLD}"
        assert got["n"] == len(c.text)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("stream-")])
def test_match_multihost_streaming_equals_the_reference(name, cluster,
                                                         tmp_path):
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
        multihost as jmultihost,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.streaming import (
        StreamingMatcher as JStreamingMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig as JConfig,
    )

    out_dir, records = cluster
    c = CASES[name]()
    path = str(out_dir / f"{name}.bin")
    pats = c.pattern if isinstance(c.pattern, list) else [c.pattern]
    size = len(c.text)
    slices = []
    for pid in range(WORLD):
        jsm = JStreamingMatcher(c.pattern, algo=c.algo,
                                config=JConfig(**{**CFG, **c.cfg}),
                                chunk_bytes=CHUNK,
                                manifest_path=str(tmp_path / f"ref.h{pid}"))
        offset, owned, _ = jmultihost.host_slice_bounds(
            size, 0, pid, WORLD, align=jsm.chunk_bytes)
        assert (offset, owned, _) == multihost.host_slice_bounds(
            size, 0, pid, WORLD, align=CHUNK)
        res = jsm.match_file(path, start=offset, stop=offset + owned,
                             drain=c.drain)
        slices.append(res if isinstance(res, list) else [res])
    for pid, rec in enumerate(records):
        got = rec["cases"][name]
        if c.resume:
            assert got["stopped_at"] == 1
        for i, (g, p) in enumerate(zip(got["results"], pats)):
            want = find_all(c.text, p)
            refs = [s[i] for s in slices]
            assert g["count"] == sum(r.count for r in refs) == len(want)
            assert not g["overflow"] and not any(r.overflow for r in refs)
            if c.gather_offsets:
                assert g["offsets"] == [int(x) for r in refs
                                        for x in r.offsets] == want
                assert g["algo"] == f"{c.algo}@stream-hosts{WORLD}"
            else:
                assert g["offsets"] == refs[pid].offsets_list()
                assert g["algo"] == (f"{c.algo}@stream-hosts{WORLD}"
                                     "!local-offsets")
            assert g["int64"] and g["n"] == size
        # The rank's manifest and journals, byte for byte.
        suffixes = [""] + ([".offsets"] if len(pats) == 1 else
                           [f".offsets.{i}" for i in range(len(pats))])
        for suffix in suffixes:
            mine = (out_dir / f"{name}.man.h{pid}{suffix}").read_bytes()
            ref = (tmp_path / f"ref.h{pid}{suffix}").read_bytes()
            assert mine == ref, (pid, suffix or "manifest")


def test_int64_gathers_keep_values_past_2_40(cluster):
    _out, records = cluster
    big = np.array(BIG, np.int64)
    rows = [(big + r).tolist() for r in range(WORLD)]
    ragged = (np.array(BIG[:-1], np.int64) + 2**40).tolist()
    for rec in records:
        assert rec["allgather"] == rows
        assert rec["allgather_2d"] == [np.reshape(row[:6], (3, 2)).tolist()
                                       for row in rows]
        assert rec["ragged"] == ragged  # rank 0's row is empty
        assert rec["ragged_empty"] == []


def test_int64_gathers_without_a_group():
    mesh = multihost.make_data_mesh(device="cpu")
    big = np.array(BIG, np.int64)
    got = multihost.allgather_i64(big, mesh)
    assert got.shape == (1, len(BIG)) and np.array_equal(got[0], big)
    assert np.array_equal(multihost.allgather_ragged_i64(big[:-1], mesh),
                          big[:-1])


def test_host_slice_bounds_match_the_reference():
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
        multihost as jmultihost,
    )

    for size in (0, 1, 999, 3000, 20000, 9 * CHUNK + 1234, 10**11 + 7):
        for pc in (1, 2, 3, 8):
            for halo in (0, 5, 1999):
                for align in (1, 64, CHUNK):
                    for pid in range(pc):
                        args = (size, halo, pid, pc, align)
                        assert (multihost.host_slice_bounds(*args)
                                == jmultihost.host_slice_bounds(*args)), args


def test_initialize_cluster_rejects_partial_topology():
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_cluster(coordinator_address="localhost:12345",
                                     process_id=0)
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_cluster(process_id=1, device="cpu")


def test_one_rank_returns_before_any_collective(tmp_path):
    """Without a group the world is one rank: the local result, tagged
    ``@hosts1``, or the stream's own result."""
    c = CASES["whole-kmp"]()
    path = tmp_path / "corpus.bin"
    path.write_bytes(c.text)
    cfg = MatchConfig(**CFG)
    r = match_multihost(str(path), "XSEAMX", algo="kmp", config=cfg,
                        device="cpu")
    assert r.algo == "kmp@hosts1" and r.offsets_list() == find_all(
        c.text, b"XSEAMX")
    r = match_multihost_streaming(str(path), b"XSEAMX", algo="kmp", config=cfg,
                                  chunk_bytes=CHUNK, device="cpu")
    assert r.algo == "kmp@stream" and r.count == len(find_all(c.text, b"XSEAMX"))


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    import torch

    path = tmp_path / "corpus.bin"
    path.write_bytes(b"abcabc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (match_multihost, match_multihost_streaming):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(str(path), b"bc")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
