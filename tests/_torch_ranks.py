"""Gloo ranks on this machine for the PyTorch port's sharded-path tests.

A test file that uses this runs itself as a script once per rank
(``python tests/test_torch_X.py <rank> <world> <port> <out_dir>``): every
rank runs every case of the file in one process group and writes one JSON
file, ``<out_dir>/rank<r>.json``, which the file's tests read.  A rank
imports torch and the port, never jax.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, world: int, out_dir, timeout: int = 240) -> list:
    """Run ``script`` as ``world`` gloo ranks and return each rank's JSON
    record, in rank order.  ``free_port`` has a close-then-rebind window,
    so a launch that lost its port to another process is tried again."""
    last = None
    for _ in range(3):
        try:
            return _run_once(script, world, out_dir, timeout)
        except AssertionError as e:
            last = e
            if "in use" not in str(e) and "Address already" not in str(e):
                raise
    raise last


def _run_once(script: str, world: int, out_dir, timeout: int) -> list:
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p and p != REPO])
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(r), str(world), str(port),
             str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(world)
    ]
    fails = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fails.append(f"rank {r} rc={p.returncode}\nstdout:"
                             f"{out.decode()[-2000:]}\nstderr:"
                             f"{err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not fails, "\n".join(fails)
    records = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def init_gloo(rank: int, world: int, port: int) -> None:
    """Join the group of a ``run_ranks`` launch, one CPU thread a rank, so
    that ranks beside other test workers do not oversubscribe the box."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))


def write_record(out_dir: str, rank: int, record: dict) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
