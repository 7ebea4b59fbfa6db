"""Multi-host matching over a shared corpus file (counterpart of the JAX
``parallel/multihost.py``; BASELINE config 5).

One process per device, all in one ``torch.distributed`` process group
(NCCL on CUDA devices, gloo on the CPU).  Each rank owns a slice of the
file and reads ``m - 1`` bytes past it, so the halo between hosts costs no
traffic; the merge is an exact int64 all-gather of per-rank counts and a
two-phase, count-sized gather of the offsets.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import MatchResult, resolve_device, valid_prefix
from ..models.registry import cached_matcher, get_matcher
from ..utils.config import DEFAULT_CONFIG
from .mesh import DataMesh, all_gather, make_data_mesh, rank_device


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> dict:
    """Create the process group unless one is initialized (idempotent; a
    call after ``destroy_process_group`` makes a new one).

    The topology comes from the arguments or the environment alone
    (``TPUMATCH_NUM_PROCESSES``, ``TPUMATCH_COORDINATOR`` as ``host:port``,
    ``TPUMATCH_PROCESS_ID``).  With none of them, or with one process, no
    group is created and the process is a world of one rank.  ``backend``
    defaults to ``nccl`` when the rank's device (``device``, default its
    CUDA device) is a CUDA device and to ``gloo`` for ``device="cpu"``;
    neither stands in for the other.  Returns the reference's topology
    facts; a rank drives one device."""
    if num_processes is None:
        env_np = os.environ.get("TPUMATCH_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPUMATCH_COORDINATOR") or None
    if process_id is None:
        env_pid = os.environ.get("TPUMATCH_PROCESS_ID")
        process_id = int(env_pid) if env_pid is not None else None
    if num_processes is None and (
        coordinator_address is not None or process_id is not None
    ):
        # A coordinator/process_id without num_processes would silently
        # stay single-process and return per-host partial results as if
        # they were global: make the misconfiguration loud instead.
        raise ValueError(
            "initialize_cluster: coordinator_address/process_id given "
            "without num_processes (set it or TPUMATCH_NUM_PROCESSES)"
        )
    if not dist.is_initialized() and (num_processes or 1) > 1:
        if process_id is None:
            raise ValueError("initialize_cluster: process_id is required "
                             "with num_processes > 1")
        dev = (rank_device(process_id) if device is None
               else resolve_device(device))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend,
            init_method=(f"tcp://{coordinator_address}"
                         if coordinator_address else None),
            world_size=num_processes,
            rank=process_id,
            device_id=dev if backend == "nccl" else None,
        )
    pid, pc = ((dist.get_rank(), dist.get_world_size())
               if dist.is_initialized() else (0, 1))
    return {"process_id": pid, "process_count": pc, "local_devices": 1,
            "global_devices": pc}


def host_slice_bounds(
    file_size: int, halo: int, process_id: int, process_count: int,
    align: int = 1,
) -> tuple[int, int, int]:
    """(offset, owned_len, read_len) for this host's corpus slice.

    The file is split evenly (aligned down to ``align``); each host reads
    ``halo`` extra bytes past its owned range (an overlapping read: the
    host-level halo needs no communication).  The last host absorbs the
    remainder.
    """
    base = file_size // process_count
    if align > 1:
        base = (base // align) * align
    offset = process_id * base
    owned = base if process_id < process_count - 1 else file_size - offset
    read = min(owned + halo, file_size - offset)
    return offset, owned, read


def load_host_slice(path: str, m: int, process_id: int | None = None,
                    process_count: int | None = None):
    """mmap-read this host's slice (+ (m-1)-byte halo) of a shared corpus.

    Returns (uint8 array of read_len bytes, global_offset, owned_len).
    Matches starting in [global_offset, global_offset+owned_len) are this
    host's; the tail halo is lookahead only.  The rank and world size
    default to the process group's (0 and 1 without one).
    """
    on = dist.is_initialized()
    pid = (dist.get_rank() if on else 0) if process_id is None else process_id
    pc = ((dist.get_world_size() if on else 1) if process_count is None
          else process_count)
    size = os.path.getsize(path)
    offset, owned, read = host_slice_bounds(size, m - 1, pid, pc)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return np.asarray(mm[offset : offset + read]), offset, owned


def allgather_i64(arr, mesh: DataMesh) -> np.ndarray:
    """Every rank's int64 array ``arr`` (one shape on all ranks), as
    ``(world, *arr.shape)`` in rank order.  ``torch.distributed`` gathers
    int64 tensors as they are, so the reference's hi/lo int32 planes (its
    gather cut int64 to int32) have no counterpart.  The tensors live on the
    mesh's device, as NCCL needs."""
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    if mesh.group is None:
        return arr[None].copy()
    t = torch.from_numpy(arr.reshape(-1)).to(mesh.device)
    out = torch.empty(mesh.world * t.numel(), dtype=torch.int64,
                      device=mesh.device)
    all_gather(out, t, mesh)
    return out.cpu().numpy().reshape((mesh.world,) + arr.shape)


def allgather_ragged_i64(local, mesh: DataMesh) -> np.ndarray:
    """Two-phase count-sized all-gather of ragged int64 rows.

    Phase 1 gathers only the per-rank lengths; phase 2 gathers rows padded
    to the largest length, not to a fixed capacity, so the traffic scales
    with the result.  Rows concatenate in rank order; with ranks owning
    ascending ranges and each row sorted, the result is sorted.
    """
    local = np.asarray(local, np.int64)
    lens = allgather_i64(np.array([len(local)], np.int64), mesh).reshape(-1)
    mx = int(lens.max())
    if mx == 0:
        return np.empty(0, np.int64)
    buf = np.full(mx, -1, np.int64)
    buf[: len(local)] = local
    rows = allgather_i64(buf, mesh)
    return np.concatenate([rows[p, : lens[p]] for p in range(len(lens))])


def _coerce(pattern):
    def one(p):
        return p.encode("utf-8") if isinstance(p, str) else bytes(p)

    return [one(p) for p in pattern] if isinstance(pattern, (list, tuple)) \
        else one(pattern)


def match_multihost_streaming(
    path: str,
    pattern,
    algo="boyer_moore",
    config=None,
    chunk_bytes: int | None = None,
    manifest_path: str | None = None,
    resume: bool = False,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    gather_offsets: bool = True,
    drain: bool = False,
    device=None,
):
    """Stream a shared corpus across the ranks: each rank streams its owned
    slice of the file in fixed chunks (``StreamingMatcher.match_file(start,
    stop)``, so a rank holds one chunk on its device, not size/N), reads
    its halo from the file, journals its own offsets, and the merge is one
    gather of per-slot (count, overflow) plus a count-sized gather of the
    offsets.  Resume is per rank: each keeps its own manifest and journals
    (``manifest_path + ".h<rank>"``) and restarts from its own last
    completed chunk.

    ``pattern``/``algo`` take the forms ``StreamingMatcher`` takes (one
    pattern and a list of algorithms, or a list of patterns and one
    algorithm).  ``gather_offsets=False`` skips the offset gather: counts
    and overflows are still global, offsets are this rank's slice only
    (``algo`` gains ``!local-offsets``).  ``drain=True`` drains each rank's
    overflowing chunks, so the offsets are complete past the per-chunk
    capacity and the overflow flag stays False.  ``device`` defaults to the
    rank's CUDA device; ``device="cpu"`` runs the plain versions on gloo.

    Every rank must call this collectively; all return the same global
    counts (and offsets, when gathered).  With one rank the local result is
    returned before any collective.
    """
    from .streaming import DEFAULT_CHUNK_BYTES, StreamingMatcher

    cfg = config or DEFAULT_CONFIG
    initialize_cluster(coordinator_address, num_processes, process_id,
                       device=device)
    mesh = make_data_mesh(device=device)
    pid, pc = mesh.rank, mesh.world
    size = os.path.getsize(path)
    sm = StreamingMatcher(
        _coerce(pattern),
        algo=algo,
        config=cfg,
        chunk_bytes=chunk_bytes or DEFAULT_CHUNK_BYTES,
        manifest_path=(manifest_path + f".h{pid}") if manifest_path else None,
        device=mesh.device,
    )
    # Ownership is split chunk-aligned, so every interior chunk is full;
    # the last rank absorbs the remainder.  halo=0: the stream already
    # reads max_m - 1 bytes past each chunk, past the slice's end too.
    offset, owned, _read = host_slice_bounds(size, 0, pid, pc,
                                             align=sm.chunk_bytes)
    local = sm.match_file(path, resume=resume, start=offset,
                          stop=offset + owned, drain=drain)
    if pc == 1:
        return local
    single = not isinstance(local, list)
    locals_ = [local] if single else local

    stats = allgather_i64(
        np.array([[r.count, int(r.overflow)] for r in locals_], np.int64),
        mesh,
    )
    results = []
    for i, r in enumerate(locals_):
        offs = np.asarray(r.offsets, np.int64)
        offs = offs[offs >= 0]
        tag = f"@stream-hosts{pc}"
        if gather_offsets:
            offs = allgather_ragged_i64(offs, mesh)
        else:
            tag += "!local-offsets"
        results.append(
            MatchResult(
                algo=r.algo.split("@")[0] + tag,
                pattern=r.pattern,
                n=size,
                count=int(stats[:, i, 0].sum()),
                offsets=offs,
                overflow=bool(stats[:, i, 1].any()),
            )
        )
    return results[0] if single else results


def match_multihost(
    path: str,
    pattern,
    algo: str = "boyer_moore",
    config=None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    drain: bool = False,
    device=None,
):
    """Match a shared corpus file across the ranks.

    Each rank reads its slice plus an (m-1)-byte tail halo from the file
    (``load_host_slice``), matches it on its device and rebases the offsets
    by the slice's file offset.  An interior rank reads exactly owned +
    (m-1) bytes, so the matcher's own limit p <= read - m is ownership.
    The merge: one int64 gather of (count, overflow) and the count-sized
    offset gather (``allgather_ragged_i64``).  ``drain=True`` runs the
    rank's match as ``match_all``, so the offsets are complete past the
    per-rank capacity.  ``device`` as in ``match_multihost_streaming``.

    Every rank must call this collectively; all return the same global
    MatchResult.  With one rank it returns before any collective.
    """
    pattern = _coerce(pattern)
    cfg = config or DEFAULT_CONFIG
    initialize_cluster(coordinator_address, num_processes, process_id,
                       device=device)
    mesh = make_data_mesh(device=device)
    pid, pc = mesh.rank, mesh.world
    size = os.path.getsize(path)
    arr, offset, _owned = load_host_slice(path, len(pattern), pid, pc)
    matcher = cached_matcher(get_matcher(algo), pattern, cfg, mesh.device)
    local = matcher.match_all(arr) if drain else matcher.match(arr)
    # Trim at the first hole BEFORE rebasing: rebasing first would turn a
    # -1 fill into a phantom offset - 1.
    local_offs = valid_prefix(np.asarray(local.offsets, np.int64)) + offset

    if pc == 1:
        return MatchResult(
            algo=f"{algo}@hosts1", pattern=pattern, n=size,
            count=local.count, offsets=local_offs, overflow=local.overflow,
        )

    stats = allgather_i64(np.array([local.count, int(local.overflow)],
                                   np.int64), mesh)
    offs = allgather_ragged_i64(local_offs, mesh)
    return MatchResult(
        algo=f"{algo}@hosts{pc}",
        pattern=pattern,
        n=size,
        count=int(stats[:, 0].sum()),
        offsets=offs,
        overflow=bool(stats[:, 1].any()),
    )
