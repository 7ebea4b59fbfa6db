"""Sharded matching over a process group, one rank per device
(counterpart of the JAX ``parallel/dist.py``).

The reference is one controller over a mesh: ``shard_map`` with
``ppermute`` halos, ``psum``/``pmax`` and ``all_gather``.  Here every rank
of a ``torch.distributed`` group (NCCL on CUDA devices, gloo on the CPU) is
called with the same text, as every JAX process passes the same global
array, and each rank:

1. copies only its own shard of the padded text to its device;
2. gets its (m-1)-byte halo from its right neighbours over the group
   (``_assemble_halo``, point-to-point, as many hops as the halo spans);
3. runs the single-device matcher's ``run`` on the shard with its logical
   length, so it reports only the matches that start in the bytes it owns;
4. joins the merge: one all-gather of a per-rank int64 stats vector
   (count, min(count, capacity), overflow) gives the global count, the
   overflow flag, the bucket size and the per-shard counts, then one gather
   of the offset rows (count-sized or capacity-wide, ``dist_gather``).

Every rank returns the same result.  The shard geometry is the
reference's: the text padded to lcm(pad_multiple, kernel tile) x world, so
every seam falls on the same byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.algorithms import RabinKarpMatcher
from ..models.base import MatchResult, pad_target, to_device, valid_prefix
from ..models.multi import RabinKarpMultiMatcher
from ..models.registry import cached_matcher, get_matcher
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.io import as_byte_array
from .mesh import DataMesh, all_gather, make_data_mesh
from .multihost import allgather_ragged_i64


def _pick_bucket(maxc: int, cap: int) -> int:
    """Power-of-two gather width >= the largest per-shard count; the floor
    of 128 keeps the number of distinct widths small (~log2(cap) - 7)."""
    if maxc <= 0:
        return 0
    return min(max(1 << (maxc - 1).bit_length(), 128), cap)


def _assemble_halo(ext: torch.Tensor, shard_len: int, halo: int,
                   mesh: DataMesh) -> None:
    """Fill ``ext[shard_len : shard_len + halo]`` with the next ``halo``
    bytes of the global stream, from as many right neighbours as the halo
    spans: rank r receives the first ``take_h`` bytes of rank r + h and
    sends its own first ``take_h`` bytes to rank r - h (a single hop once
    dropped the matches of m - 1 > shard_len).  Bytes past the last rank
    stay zero, as the global padding past n is."""
    hops = min(-(-halo // shard_len), mesh.world - 1)
    ops, rem = [], halo
    for h in range(1, hops + 1):
        take = min(shard_len, rem)
        if mesh.rank - h >= 0:
            ops.append(dist.P2POp(
                dist.isend, ext[:take],
                dist.get_global_rank(mesh.group, mesh.rank - h), mesh.group))
        if mesh.rank + h < mesh.world:
            lo = h * shard_len
            ops.append(dist.P2POp(
                dist.irecv, ext[lo : lo + take],
                dist.get_global_rank(mesh.group, mesh.rank + h), mesh.group))
        rem -= take
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()


def _stats(offs: torch.Tensor, count: int, overflow: bool,
           cap: int) -> torch.Tensor:
    """int64[3] on the device: (count, min(count, cap), overflow) of one
    ``run`` triple, overflow also when the offsets' valid prefix is short
    of the count."""
    stats = torch.tensor([count, min(count, cap), int(overflow)],
                         dtype=torch.int64, device=offs.device)
    stats[2] |= (_valid(offs).sum() < count).to(torch.int64)
    return stats


def _valid(offs: torch.Tensor) -> torch.Tensor:
    """int64 1s over the ascending valid prefix of ``offs``, then 0s."""
    return torch.cumprod((offs >= 0).to(torch.int64), 0)


def _row(offs: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """int64[width] on the device: the valid prefix of ``offs`` rebased by
    ``start`` in int64, filled with -1 (rebasing a -1 first would make a
    phantom offset)."""
    row = torch.full((width,), -1, dtype=torch.int64, device=offs.device)
    k = min(width, offs.numel())
    row[:k] = torch.where(_valid(offs[:k]).bool(),
                          offs[:k].to(torch.int64) + start, -1)
    return row


class _Sharded:
    """What both matchers share: the shard geometry, staging, the halo,
    the gathers and the per-rank drain.  Subclasses set ``mesh``,
    ``config``, ``m`` and ``_tile``."""

    mesh: DataMesh
    config: MatchConfig
    m: int
    _tile: int

    def _shard(self, arr: np.ndarray):
        """(text, n_local, shard_start, shard_len): this rank's shard of the
        padded text with its halo, on its device and padded as ``run``
        takes it, and its logical length."""
        n, mesh = len(arr), self.mesh
        step = self._tile * mesh.world
        shard_len = -(-max(n, 1) // step) * step // mesh.world
        start = mesh.rank * shard_len
        halo = self.m - 1 if mesh.world > 1 else 0
        ext = torch.zeros(self._padded(shard_len + halo), dtype=torch.uint8,
                          device=mesh.device)
        own = arr[start : min(start + shard_len, n)]
        if len(own):
            ext[: len(own)].copy_(to_device(own, torch.device("cpu")))
        if halo:
            _assemble_halo(ext, shard_len, halo, mesh)
        # Logical n, never the padded length: global validity
        # (p + start <= n - m) and ownership (p < shard_len) as one length.
        n_local = min(max(n - start, 0), shard_len + halo)
        # No start lies past n_local, so the scan stops at its pad target,
        # as ``Matcher.match`` pads a text of n_local bytes: a shard the text
        # ends in scans no padding.
        return ext[: self._padded(n_local)], n_local, start, shard_len

    def _padded(self, n: int) -> int:
        """n rounded up to the matcher's pad target (whole 4096-byte rows,
        whole kernel tiles once the text fills one)."""
        mult = pad_target(n, self.config, self._tile)
        return -(-max(n, 1) // mult) * mult

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """(world, *local.shape) of every rank's ``local``, on the device."""
        mesh = self.mesh
        if mesh.group is None:
            return local[None]
        out = torch.empty((mesh.world,) + tuple(local.shape),
                          dtype=local.dtype, device=local.device)
        if local.numel():
            all_gather(out.view(-1), local.contiguous().view(-1), mesh)
        return out

    def _merge(self, stats: torch.Tensor, rows_of) -> tuple:
        """(stats (world, ...), rows (world, ..., width)) on the host:
        ``rows_of(width)`` gives this rank's rows at a width, capacity-wide
        under 'fixed', else the bucket of the largest per-shard count (no
        gather when it is 0)."""
        cap = self.config.capacity
        all_stats = self._gather(stats)
        if self.config.dist_gather == "fixed":
            rows = self._gather(rows_of(cap))
            return all_stats.cpu().numpy(), rows.cpu().numpy()
        all_stats = all_stats.cpu().numpy()
        bucket = _pick_bucket(int(all_stats[..., 1].max()), cap)
        return all_stats, self._gather(rows_of(bucket)).cpu().numpy()

    def _drain_own(self, arr, matcher, count: int, row: np.ndarray,
                   shard_len: int) -> np.ndarray:
        """Every offset of this rank's shard: its gathered row when that is
        complete, else the owned range re-extracted by the single-device
        matcher's windowed drain, whose ownership is the shard's."""
        row = valid_prefix(row)
        if len(row) == count:
            return row
        lo = self.mesh.rank * shard_len
        return matcher.extract_range(arr, lo, min(lo + shard_len, len(arr)),
                                     count)

    def _check_drain(self) -> None:
        if self.config.capacity == 0:
            raise ValueError("drain=True needs capacity >= 1; capacity=0 is "
                             "count-only")


def _flat(rows: np.ndarray) -> np.ndarray:
    offs = rows.reshape(-1)
    return np.sort(offs[offs >= 0])


class DistributedMatcher(_Sharded):
    """Sharded exact matcher (any registered algorithm), one rank per
    device of ``mesh`` (default ``make_data_mesh(device=device)``)."""

    def __init__(
        self,
        pattern: bytes,
        algo: str = "boyer_moore",
        config: MatchConfig = DEFAULT_CONFIG,
        mesh: DataMesh | None = None,
        device=None,
    ):
        self.mesh = mesh if mesh is not None else make_data_mesh(device=device)
        self.n_shards = self.mesh.world
        cls = get_matcher(algo)
        self.matcher = cached_matcher(cls, bytes(pattern), config,
                                      self.mesh.device)
        # The matcher may specialize the config per pattern (BM probe
        # layout).
        self.config = self.matcher.config
        self.m = self.matcher.m
        self._tile = int(np.lcm(self.config.pad_multiple,
                                cls._tile_bytes(self.config)))

    def _match_raw(self, arr: np.ndarray):
        """(MatchResult without offsets, per-shard counts (world,),
        per-shard offset rows (world, width) rebased and -1-filled,
        shard_len)."""
        ext, n_local, start, shard_len = self._shard(arr)
        count, offs, ovf = self.matcher.run(ext, n_local)
        all_stats, rows = self._merge(
            _stats(offs, count, ovf, self.config.capacity),
            lambda w: _row(offs, start, w))
        res = MatchResult(
            algo=f"{self.matcher.name}@mesh{self.n_shards}",
            pattern=self.matcher.pattern_bytes,
            n=len(arr),
            count=int(all_stats[:, 0].sum()),
            offsets=None,  # filled by callers from rows
            overflow=bool(all_stats[:, 2].any()),
        )
        return res, all_stats[:, 0], rows, shard_len

    def match(self, data) -> MatchResult:
        res, _counts, rows, _sl = self._match_raw(as_byte_array(data))
        return dataclasses.replace(res, offsets=_flat(rows))

    def match_all(self, data) -> MatchResult:
        """Like ``match`` but returns EVERY offset even past capacity: each
        rank whose gathered row is short of its shard's count re-extracts
        its own shard (``Matcher.extract_range``), and a ragged int64 gather
        merges the complete rows.  Raises ValueError for ``capacity=0``
        before any scan."""
        self._check_drain()
        arr = as_byte_array(data)
        res, shard_counts, rows, shard_len = self._match_raw(arr)
        if not res.overflow:
            return dataclasses.replace(res, offsets=_flat(rows))
        r = self.mesh.rank
        mine = self._drain_own(arr, self.matcher, int(shard_counts[r]),
                               rows[r], shard_len)
        offsets = allgather_ragged_i64(mine, self.mesh)
        if len(offsets) != res.count:
            raise RuntimeError(
                f"drain found {len(offsets)} offsets for count {res.count}")
        return dataclasses.replace(res, offsets=offsets, overflow=False)


class DistributedMultiMatcher(_Sharded):
    """Sharded multi-pattern matcher: k equal-length patterns, one shared
    Rabin-Karp hash pass per shard (``RabinKarpMultiMatcher``), merged per
    pattern with the same two gathers, on (k, 3) stats and (k, width)
    rows."""

    def __init__(self, patterns, config: MatchConfig = DEFAULT_CONFIG,
                 mesh: DataMesh | None = None, device=None):
        self.mesh = mesh if mesh is not None else make_data_mesh(device=device)
        self.n_shards = self.mesh.world
        self.matcher = cached_matcher(RabinKarpMultiMatcher,
                                      tuple(bytes(p) for p in patterns),
                                      config, self.mesh.device)
        self.config = config
        self.m = self.matcher.m
        self.k = self.matcher.k
        self._tile = int(np.lcm(config.pad_multiple,
                                RabinKarpMatcher._tile_bytes(config)))

    def _match_raw(self, arr: np.ndarray):
        """(k MatchResults without offsets, per-shard counts (world, k),
        rows (world, k, width), shard_len)."""
        ext, n_local, start, shard_len = self._shard(arr)
        outs = self.matcher.run(ext, n_local)
        cap = self.config.capacity

        all_stats, rows = self._merge(
            torch.stack([_stats(o, c, v, cap) for c, o, v in outs]),
            lambda w: torch.stack([_row(o, start, w) for _c, o, _v in outs]))
        results = [
            MatchResult(
                algo=f"rabin_karp_multi@mesh{self.n_shards}",
                pattern=p, n=len(arr), count=int(all_stats[:, i, 0].sum()),
                offsets=None, overflow=bool(all_stats[:, i, 2].any()),
            )
            for i, p in enumerate(self.matcher.patterns)
        ]
        return results, all_stats[..., 0], rows, shard_len

    def match(self, data) -> list[MatchResult]:
        results, _sc, rows, _sl = self._match_raw(as_byte_array(data))
        return [dataclasses.replace(r, offsets=_flat(rows[:, i]))
                for i, r in enumerate(results)]

    def match_all(self, data) -> list[MatchResult]:
        """``match`` with the drain of ``DistributedMatcher.match_all`` per
        overflowing pattern, each rank re-extracting its own slot with the
        pattern's single-pattern Rabin-Karp matcher."""
        self._check_drain()
        arr = as_byte_array(data)
        results, shard_counts, rows, shard_len = self._match_raw(arr)
        r = self.mesh.rank
        out = []
        for i, res in enumerate(results):
            if not res.overflow:
                out.append(dataclasses.replace(res, offsets=_flat(rows[:, i])))
                continue
            single = cached_matcher(RabinKarpMatcher, res.pattern,
                                    self.config, self.mesh.device)
            mine = self._drain_own(arr, single, int(shard_counts[r, i]),
                                   rows[r, i], shard_len)
            offsets = allgather_ragged_i64(mine, self.mesh)
            if len(offsets) != res.count:
                raise RuntimeError(
                    f"drain found {len(offsets)} offsets for count "
                    f"{res.count}")
            out.append(dataclasses.replace(res, offsets=offsets,
                                           overflow=False))
        return out
