"""PyTorch port: ``match_distributed`` (``…_torch/parallel/dist.py``) on
gloo ranks against the JAX package's ``match_distributed`` on the 8-device
CPU mesh of ``tests/conftest.py``, and against the oracle.

One cluster of 8 ranks, this file run as a script once per rank, runs
every case of ``tests/test_distributed.py`` (the same config, texts,
seeds and planted seams) plus count-only, NUL-ending and direct halo cases,
and writes one JSON file per rank; each test reads the ranks' records
through a module fixture and holds every rank's result (count, offsets,
overflow, ``algo`` tag and shard_len) against the reference computed in
the test process.
Where the reference reports ``overflow=True`` the overflow rule holds per
shard: equal counts, and each shard's row an ascending prefix of the
oracle's offsets in that shard.

The shards are whole kernel tiles, lcm(pad_multiple, tile) bytes, at least
64 KiB, as in the reference: the reference's m=1500 case now spans one
seam, and the multi-hop halo (m - 1 > shard_len) is held by
``test_halo_hops_at_world_8``, which drives ``_assemble_halo`` with
16-byte shards directly: a match of m > 64 KiB takes seconds a call on
the plain versions.

World 1 runs in this process without a group, against the reference's
``make_data_mesh(1)``.  The JAX package is imported only inside the
fixtures and tests that compute the reference.
"""

import _torch_threads  # noqa: F401

import dataclasses
import os
import sys
import traceback

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    DistributedMatcher,
    DistributedMultiMatcher,
    MatchConfig,
    match_distributed,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.base import (
    valid_prefix,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel import (
    dist as pdist,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.parallel.mesh import (
    make_data_mesh,
)

WORLD = 8
ALGOS = ["naive", "rabin_karp", "kmp", "boyer_moore"]
# tests/test_distributed.py:25
CFG = {"capacity": 1024, "verify_capacity": 1024, "kmp_chunk": 64,
       "bm_chunk": 64, "pad_multiple": 64}


@dataclasses.dataclass(frozen=True)
class Case:
    text: bytes
    pattern: object  # bytes, or a list of bytes
    algo: str
    cfg: dict = dataclasses.field(default_factory=dict)
    drain: bool = False


CASES: dict = {}


def case(name):
    def reg(fn):
        CASES[name] = fn
        return fn
    return reg


def _random_ab():
    rng = np.random.default_rng(42)
    return rng.choice(np.frombuffer(b"ab", dtype=np.uint8), size=3000).tobytes()


for _a in ALGOS:
    case(f"random-{_a}")(lambda a=_a: Case(_random_ab(), b"abba", a))


def _seams():
    n, shard, m, pattern = 4096, 4096 // WORLD, 6, b"QWERTY"
    text = bytearray(b"." * n)
    for b in range(1, WORLD):
        text[b * shard - 3 : b * shard - 3 + m] = pattern
    text[0:m] = pattern
    text[n - m :] = pattern
    return bytes(text)


for _a in ALGOS:
    case(f"seams-{_a}")(lambda a=_a: Case(_seams(), b"QWERTY", a))


@case("unpadded-tail")
def _():
    return Case(b"a" * 1001 + b"zz", b"zz", "naive")


def _long_pattern():
    rng = np.random.default_rng(7)
    data = bytearray(rng.integers(ord("a"), ord("e"), size=8192,
                                  dtype=np.uint8).tobytes())
    pattern = bytes(rng.integers(ord("f"), ord("z"), size=1500,
                                 dtype=np.uint8).tobytes())
    data[2000 : 2000 + 1500] = pattern
    return bytes(data), pattern


for _a in ALGOS:
    case(f"m1500-{_a}")(lambda a=_a: Case(*_long_pattern(), a))


_CYCLE = bytes(bytearray(range(256)) * 24)


@case("spanning-most")
def _():
    return Case(_CYCLE, _CYCLE[100 : 100 + 5000], "naive")


@case("absent-long")
def _():
    return Case(_CYCLE, b"\xff" * 5000, "kmp")


@case("multi-rk-shared-pass")
def _():
    rng = np.random.default_rng(11)
    data = bytearray(rng.integers(97, 105, size=6000, dtype=np.uint8).tobytes())
    p1, p2, p3 = b"ZAP!", b"WOW?", b"LONGER0"
    shard = 6016 // 8
    for pos, p in [(0, p1), (shard - 2, p1), (3 * shard - 1, p2),
                   (2000, p2), (5 * shard - 3, p3), (5990, p1)]:
        data[pos : pos + len(p)] = p
    return Case(bytes(data), [p1, p2, p3], "rabin_karp")


@case("multi-kmp")
def _():
    return Case(b"abcabcabc" * 300, [b"abca", b"cab"], "kmp",
                {"capacity": 4096})


@case("overlap-seams")
def _():
    return Case(b"a" * 2048, b"aaaa", "kmp", {"capacity": 4096})


def _abc():
    rng = np.random.default_rng(7)
    return rng.choice(np.frombuffer(b"abc", dtype=np.uint8), size=5000).tobytes()


def _dense(spans, n):
    text = bytearray(b"." * n)
    for lo, hi in spans:
        text[lo:hi] = b"a" * (hi - lo)
    return bytes(text)


for _mode in ("count_sized", "fixed"):
    case(f"gather-{_mode}")(
        lambda m=_mode: Case(_abc(), b"abcabc", "naive", {"dist_gather": m}))
    case(f"gather-zero-{_mode}")(
        lambda m=_mode: Case(_abc(), b"ZZZZ", "naive", {"dist_gather": m}))
    # A shard with more matches than the 128-entry bucket floor
    # (tests/test_distributed.py:183).
    case(f"bucket-grows-{_mode}")(
        lambda m=_mode: Case(_dense([(0, 400), (5000, 5020)], 8192), b"aa",
                             "naive", {"dist_gather": m,
                                       "pallas_chunk_bytes": 512}))
    case(f"drain-{_mode}")(
        lambda m=_mode: Case(_dense([(0, 600), (2560, 2600)], 4096), b"aa",
                             "naive", {"capacity": 16, "dist_gather": m},
                             drain=True))


@case("bucket-past-floor")
def _():
    return Case(_dense([(0, 600)], 4096), b"aa", "naive",
                {"dist_gather": "count_sized"})


@case("multi-drain")
def _():
    text = bytearray(b"." * 4096)
    text[0:200] = b"ab" * 100
    text[3000:3008] = b"cd" * 4
    return Case(bytes(text), [b"ab", b"cd"], "rabin_karp", {"capacity": 16},
                drain=True)


for _a in ALGOS:
    case(f"count-only-{_a}")(
        lambda a=_a: Case(_random_ab(), b"abba", a, {"capacity": 0}))
case("count-only-absent")(
    lambda: Case(_random_ab(), b"abcd", "kmp", {"capacity": 0}))


def _nul_text():
    """150,001 bytes with no NUL over three 64 KiB shards (tiles of
    ``pallas_chunk_bytes=512``): b"ab\\0\\0" straddles the first seam and
    lies inside the second shard, and the text ends in b"ab", next to the
    zero padding."""
    rng = np.random.default_rng(5)
    data = bytearray(rng.integers(1, 256, size=150_001, dtype=np.uint8).tobytes())
    for pos in (65536 - 2, 100_000):
        data[pos : pos + 4] = b"ab\x00\x00"
    data[-2:] = b"ab"
    return bytes(data)


for _a in ALGOS:
    case(f"nul-ending-{_a}")(
        lambda a=_a: Case(_nul_text(), b"ab\x00\x00", a,
                          {"pallas_chunk_bytes": 512}))

HALO_SHARD = 16
HALOS = (1, 15, 16, 17, 50, 100, 127)


def _stream_byte(i: np.ndarray) -> np.ndarray:
    return (i * 7 + 3) % 251 + 1


# -- the ranks -------------------------------------------------------------


def _port_case(c: Case) -> dict:
    cfg = MatchConfig(**{**CFG, **c.cfg})
    rs = match_distributed(c.text, c.pattern, algo=c.algo, config=cfg,
                           drain=c.drain, device="cpu")
    rec = {"results": [{"count": r.count, "offsets": r.offsets_list(),
                        "overflow": r.overflow, "algo": r.algo,
                        "int64": r.offsets.dtype == np.int64}
                       for r in (rs if isinstance(rs, list) else [rs])]}
    if not isinstance(c.pattern, list):
        dm = DistributedMatcher(c.pattern, algo=c.algo, config=cfg,
                                device="cpu")
        _res, _counts, rows, shard_len = dm._match_raw(
            np.frombuffer(c.text, np.uint8))
        rec["shard_len"] = shard_len
        rec["rows"] = [valid_prefix(r).tolist() for r in rows]
    return rec


def _halo_records(rank: int, world: int) -> dict:
    """Each halo of ``HALOS`` assembled over 16-byte shards of the global
    stream ``_stream_byte(arange(16 * world))``: what rank ``rank`` holds
    past its shard."""
    mesh = make_data_mesh(device="cpu")
    out = {}
    for halo in HALOS:
        ext = torch.zeros(HALO_SHARD + halo, dtype=torch.uint8)
        own = np.arange(rank * HALO_SHARD, (rank + 1) * HALO_SHARD)
        ext[:HALO_SHARD] = torch.from_numpy(_stream_byte(own).astype(np.uint8))
        pdist._assemble_halo(ext, HALO_SHARD, halo, mesh)
        out[str(halo)] = ext[HALO_SHARD:].tolist()
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from _torch_ranks import init_gloo, write_record

    init_gloo(rank, world, port)
    try:
        mesh = make_data_mesh(device="cpu")
        record = {"mesh": [mesh.rank, mesh.world], "cases": {},
                  "halo": _halo_records(rank, world)}
        for name, make in CASES.items():
            try:
                record["cases"][name] = _port_case(make())
            except Exception:  # recorded: the case's test reports it
                record["cases"][name] = {"error": traceback.format_exc()}
        write_record(out_dir, rank, record)
    finally:
        dist.destroy_process_group()


# -- the tests ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _torch_ranks import run_ranks

    return run_ranks(os.path.abspath(__file__), WORLD,
                     tmp_path_factory.mktemp("dist_ranks"))


@pytest.fixture(scope="module")
def jax_dist():
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
        MatchConfig as JConfig,
        match_distributed as jmatch_distributed,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        DistributedMatcher as JDistributedMatcher,
    )

    return JConfig, jmatch_distributed, JDistributedMatcher


def _reference(c: Case, jax_dist) -> dict:
    JConfig, jmatch, JDM = jax_dist
    cfg = JConfig(**{**CFG, **c.cfg})
    rs = jmatch(c.text, c.pattern, algo=c.algo, config=cfg, drain=c.drain)
    ref = {"results": rs if isinstance(rs, list) else [rs]}
    if not isinstance(c.pattern, list):
        ref["shard_len"] = JDM(c.pattern, algo=c.algo, config=cfg)._match_raw(
            np.frombuffer(c.text, np.uint8))[3]
    return ref


def test_ranks_form_one_mesh(ranks):
    assert [r["mesh"] for r in ranks] == [[i, WORLD] for i in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_world_8_matches_the_reference(name, ranks, jax_dist):
    c = CASES[name]()
    ref = _reference(c, jax_dist)
    pats = c.pattern if isinstance(c.pattern, list) else [c.pattern]
    wants = [find_all(c.text, p) for p in pats]
    for rank, record in enumerate(ranks):
        got = record["cases"][name]
        assert "error" not in got, f"rank {rank}: {got.get('error')}"
        assert len(got["results"]) == len(pats)
        for g, r, want in zip(got["results"], ref["results"], wants):
            assert g["algo"] == r.algo, (rank, g["algo"], r.algo)
            assert g["count"] == r.count == len(want), rank
            assert g["overflow"] == r.overflow, rank
            assert g["int64"]
            if not r.overflow:
                assert g["offsets"] == r.offsets_list() == want, rank
        if "shard_len" in ref:
            assert got["shard_len"] == ref["shard_len"], rank
            if ref["results"][0].overflow:
                # The overflow rule, shard by shard.
                sl, want = got["shard_len"], np.array(wants[0], np.int64)
                for s, row in enumerate(got["rows"]):
                    mine = want[(want >= s * sl) & (want < (s + 1) * sl)]
                    assert row == mine[: len(row)].tolist(), (rank, s)


def test_results_name_the_mesh(ranks):
    got = ranks[3]["cases"]
    assert got["random-kmp"]["results"][0]["algo"] == f"kmp@mesh{WORLD}"
    assert [r["algo"] for r in got["multi-rk-shared-pass"]["results"]] == [
        f"rabin_karp_multi@mesh{WORLD}"] * 2 + [f"rabin_karp@mesh{WORLD}"]
    # Count-only: the exact count, no offsets, overflow when there is a match.
    c = got["count-only-boyer_moore"]["results"][0]
    assert c["count"] > 0 and c["offsets"] == [] and c["overflow"]


@pytest.mark.parametrize("halo", HALOS)
def test_halo_hops_at_world_8(halo, ranks):
    """Rank r holds the ``halo`` bytes after its 16-byte shard: up to 7
    hops of neighbours, zeros past the last rank."""
    stream = np.zeros(HALO_SHARD * WORLD + halo, np.int64)
    stream[: HALO_SHARD * WORLD] = _stream_byte(np.arange(HALO_SHARD * WORLD))
    for r, record in enumerate(ranks):
        lo = (r + 1) * HALO_SHARD
        assert record["halo"][str(halo)] == stream[lo : lo + halo].tolist(), r


# -- world 1, in this process, no group --------------------------------------


def _world1_text():
    rng = np.random.default_rng(51)
    data = bytearray(rng.integers(97, 123, size=20000, dtype=np.uint8).tobytes())
    for p in (0, 7777, 20000 - 6):
        data[p : p + 6] = b"XYZZYX"
    data[5000:5006] = b"QQWWEE"
    return bytes(data)


@pytest.mark.parametrize("emission", ["sparse", "nib"])
@pytest.mark.parametrize("algo", ALGOS)
def test_world_1_matches_make_data_mesh_1(algo, emission, jax_dist):
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
        make_data_mesh as jmake_data_mesh,
    )

    JConfig, jmatch, JDM = jax_dist
    text = _world1_text()
    kw = {**CFG, "emission": emission}
    got = match_distributed(text, b"XYZZYX", algo=algo, config=MatchConfig(**kw),
                            device="cpu")
    ref = jmatch(text, b"XYZZYX", algo=algo, config=JConfig(**kw),
                 mesh=jmake_data_mesh(1))
    assert got.algo == ref.algo == f"{got.algo.split('@')[0]}@mesh1"
    assert (got.count, got.offsets_list(), got.overflow) == (
        ref.count, ref.offsets_list(), ref.overflow)
    assert got.offsets_list() == find_all(text, b"XYZZYX")
    dm = DistributedMatcher(b"XYZZYX", algo=algo, config=MatchConfig(**kw),
                            device="cpu")
    jdm = JDM(b"XYZZYX", algo=algo, config=JConfig(**kw), mesh=jmake_data_mesh(1))
    arr = np.frombuffer(text, np.uint8)
    assert dm._match_raw(arr)[3] == jdm._match_raw(arr)[3]


def test_world_1_multi_pattern_matches_make_data_mesh_1(jax_dist):
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
        make_data_mesh as jmake_data_mesh,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        DistributedMultiMatcher as JDistributedMultiMatcher,
    )

    JConfig = jax_dist[0]
    text, pats = _world1_text(), [b"XYZZYX", b"QQWWEE"]
    got = DistributedMultiMatcher(pats, config=MatchConfig(**CFG),
                                  device="cpu").match(text)
    ref = JDistributedMultiMatcher(pats, config=JConfig(**CFG),
                                   mesh=jmake_data_mesh(1)).match(text)
    for g, r, p in zip(got, ref, pats):
        assert g.algo == r.algo == "rabin_karp_multi@mesh1"
        assert (g.count, g.offsets_list(), g.overflow) == (
            r.count, r.offsets_list(), r.overflow)
        assert g.offsets_list() == find_all(text, p)


def test_world_1_needs_no_group_and_defaults_to_the_card(monkeypatch):
    mesh = make_data_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world, mesh.device.type) == (
        None, 0, 1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        match_distributed(b"abc", b"b")
    with pytest.raises(ValueError, match="not initialized"):
        make_data_mesh(group=object(), device="cpu")


def test_drain_with_count_only_raises_before_any_scan(monkeypatch):
    def no_scan(*a, **kw):
        raise AssertionError("scanned")

    monkeypatch.setattr(pdist._Sharded, "_shard", no_scan)
    for pattern in (b"ab", [b"ab", b"cd"]):
        with pytest.raises(ValueError, match="capacity=0"):
            match_distributed(b"abcd" * 100, pattern, algo="rabin_karp",
                              capacity=0, drain=True, device="cpu")


# -- pure functions ------------------------------------------------------------


def test_pick_bucket_matches_the_reference():
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        _pick_bucket as jpick,
    )

    for cap in (0, 1, 16, 127, 128, 129, 1000, 1024, 65536):
        for maxc in (-1, 0, 1, 2, 3, 100, 127, 128, 129, 255, 256, 257,
                     1023, 1024, 1025, 70000):
            assert pdist._pick_bucket(maxc, cap) == jpick(maxc, cap), (maxc, cap)


def test_unknown_dist_gather_raises():
    with pytest.raises(ValueError, match="dist_gather"):
        MatchConfig(dist_gather="bogus")
    assert MatchConfig().dist_gather == "count_sized"
    assert MatchConfig(dist_gather="fixed").dist_gather == "fixed"


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
