"""PyTorch port: the command line's ``--distributed`` and ``--multihost``
at world 2 on gloo.

One cluster of 2 ranks, this file run as a script once per rank
(``tests/_torch_ranks.py``), runs every case.  Per case each rank sets the
launcher's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` for ``--distributed``; the
``TPUMATCH_*`` ones for ``--multihost``) on a fresh port that rank 0 hands
out through a store of the harness, calls ``main([...], device="cpu")``,
which makes the group and destroys it, and records its output.

- ``--distributed``: rank 0 prints the single-device port's lines, but
  for the ``@mesh2`` of ``algo``; rank 1 prints nothing;
- ``--multihost`` (and ``--stream --multihost``): both ranks print the
  same global result, the one-process run's lines but for the world size
  in ``algo``;
- counts and offsets equal ``conformance/oracle.find_all``.

Cases: one pattern, a pattern list under ``rk``, ``--drain`` past
capacity, and a match planted across each seam (the shard seam of
``--distributed`` and the slice seam of ``--multihost``).
"""

import _torch_threads  # noqa: F401

import contextlib
import datetime
import io
import json
import os
import re
import sys

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import cli
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)

WORLD = 2
SEAM_BYTES = 700_000
# At world 2 the naive and Boyer-Moore shards are 512 KiB (the SWAR tile
# times the world divides the padded text); the hosts split the file in two.
SHARD_SEAM, HOST_SEAM = 1 << 19, SEAM_BYTES // 2
DENSE_BYTES = 2_500_000  # three 1 MiB chunks, so rank 0 streams one

CASES = {
    "single": ["bm", "{seam}", "XSEAMX", "--json", "--offsets", "-1"],
    "list-rk": ["rk", "{seam}", "XSEAMX", "quick ", "the", "--json"],
    "drain": ["naive", "{dense}", "aa", "--capacity", "16", "--drain", "--json",
              "--offsets", "-1"],
    "seam": ["naive", "{seam}", "XSEAMX", "--offsets", "-1"],
}
MODES = {"distributed": ["--distributed"], "multihost": ["--multihost"],
         "stream-multihost": ["--stream", "--multihost", "--chunk-mb", "1"]}
RUNS = [(c, m) for m in MODES for c in CASES
        if m != "stream-multihost" or c in ("single", "drain")]
LAUNCHER = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
            "TPUMATCH_NUM_PROCESSES", "TPUMATCH_COORDINATOR", "TPUMATCH_PROCESS_ID")


def _seam_text() -> bytes:
    data = bytearray(gen_english(SEAM_BYTES, seed=53))
    for p in (0, 123_457, SHARD_SEAM - 3, HOST_SEAM - 3, SEAM_BYTES - 6):
        data[p : p + 6] = b"XSEAMX"
    return bytes(data)


def _dense_text() -> bytes:
    rng = np.random.default_rng(59)
    return np.where(rng.random(DENSE_BYTES) < 0.1, ord("a"), ord("e")).astype(
        np.uint8).tobytes()


def _argv(case: str, mode: str | None, out_dir) -> list:
    paths = {"seam": os.path.join(out_dir, "seam.bin"),
             "dense": os.path.join(out_dir, "dense.bin")}
    return [a.format(**paths) for a in CASES[case]] + (MODES[mode] if mode else [])


def _main(argv) -> dict:
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = cli.main(argv, device="cpu")
    return {"rc": rc, "out": o.getvalue(), "err": e.getvalue()}


# -- the ranks ---------------------------------------------------------------


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from _torch_ranks import free_port, write_record

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          timeout=datetime.timedelta(seconds=120))
    record = {}
    for i, (case, mode) in enumerate(RUNS):
        if rank == 0:
            store.set(f"port{i}", str(free_port()))
        p = store.get(f"port{i}").decode()
        for k in LAUNCHER:
            os.environ.pop(k, None)
        if mode == "distributed":
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=p)
        else:
            os.environ.update(TPUMATCH_NUM_PROCESSES=str(world),
                              TPUMATCH_COORDINATOR=f"127.0.0.1:{p}",
                              TPUMATCH_PROCESS_ID=str(rank))
        rec = _main(_argv(case, mode, out_dir))
        rec["group_left"] = dist.is_initialized()
        record[f"{case}/{mode}"] = rec
    write_record(out_dir, rank, record)


# -- the tests ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from _torch_ranks import run_ranks

    out_dir = tmp_path_factory.mktemp("cli_ranks")
    texts = {"seam": _seam_text(), "dense": _dense_text()}
    for k, data in texts.items():
        (out_dir / f"{k}.bin").write_bytes(data)
    return out_dir, texts, run_ranks(os.path.abspath(__file__), WORLD, out_dir)


def base_algo(line: str):
    """A line without ``wall_s`` and with ``algo``'s ``@...`` suffix cut."""
    try:
        row = json.loads(line)
    except ValueError:
        return re.sub(r"@[\w-]+: pattern", ": pattern", line)
    row.pop("wall_s")
    row["algo"] = row["algo"].split("@")[0]
    return row


def lines(out: str) -> list:
    return [base_algo(x) for x in out.splitlines()]


def test_every_rank_ran_every_case_and_left_no_group(cluster):
    _out, _texts, records = cluster
    for rec in records:
        assert list(rec) == [f"{c}/{m}" for c, m in RUNS]
        for run in rec.values():
            assert run["rc"] == 0 and not run["group_left"]


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_rank0_prints_the_single_device_lines(case, cluster):
    out_dir, _texts, (r0, r1) = cluster
    single = _main(_argv(case, None, out_dir))
    got = r0[f"{case}/distributed"]
    assert lines(got["out"]) == lines(single["out"]) and single["out"]
    assert "@mesh2" in got["out"] and "@mesh" not in single["out"]
    assert r1[f"{case}/distributed"]["out"] == r1[f"{case}/distributed"]["err"] == ""


@pytest.mark.parametrize("run", [f"{c}/{m}" for c, m in RUNS if m != "distributed"])
def test_multihost_ranks_print_the_same_global_result(run, cluster):
    out_dir, _texts, (r0, r1) = cluster
    case, mode = run.split("/")
    assert lines(r0[run]["out"]) == lines(r1[run]["out"])
    one = _main(_argv(case, mode, out_dir))  # no TPUMATCH_*: a world of one
    assert lines(r0[run]["out"]) == lines(one["out"]) and one["out"]
    tag = "@stream-hosts2" if mode == "stream-multihost" else "@hosts2"
    assert tag in r0[run]["out"] and tag in r1[run]["out"]


@pytest.mark.parametrize("run", [f"{c}/{m}" for c, m in RUNS])
def test_counts_and_offsets_equal_the_oracle(run, cluster):
    out_dir, texts, (r0, _r1) = cluster
    case, mode = run.split("/")
    args = cli.build_parser().parse_args(_argv(case, mode, out_dir))
    text = texts[os.path.basename(args.textfile)[:-4]]
    pats = [p.encode() for p in args.pattern]
    if mode == "multihost":
        pats = pats[:1]  # the reference's --multihost takes the first pattern
    got = r0[run]["out"].splitlines()
    assert len(got) == len(pats)
    for pat, line in zip(pats, got):
        want = find_all(text, pat)
        if args.json:
            row = json.loads(line)
            assert row["count"] == len(want) and not row["overflow"]
            k = len(want) if args.offsets < 0 else min(args.offsets, len(want))
            assert row["offsets"] == want[:k]
        else:
            assert f": {len(want)} match(es) at {want}" in line
    if case in ("single", "seam"):
        starts = find_all(text, b"XSEAMX")
        assert SHARD_SEAM - 3 in starts and HOST_SEAM - 3 in starts


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
