"""What every traffic mix shares: the pool of queries drawn from the seed,
the order they are taken in, the answers kept for the check, and the base
of the entries that drive the port.

A traffic file names its entry, ``entries/<entry>.py``, which defines
``Entry``: a subclass of ``workload.Entry`` whose ``query(k)`` runs pool
item k through the port and returns its answers on the host.  A
configuration file names the algorithm, the ``MatchConfig`` fields, the
corpus and the pattern recipe.  Every entry takes the same pool from the
same seed.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import numpy as np
import torch

from . import corpus

PORT = "parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch"


def port_module(name: str = ""):
    """The port's package, or its module ``name``, imported once the
    caches are set."""
    return importlib.import_module(f"{PORT}.{name}" if name else PORT)


@dataclasses.dataclass
class Answer:
    """What a query returned for one pattern, on the host."""

    pattern: bytes
    count: int
    offsets: np.ndarray
    overflow: bool


def answers(results) -> list:
    """``Answer``s of the port's ``MatchResult``s."""
    return [Answer(r.pattern, int(r.count), np.asarray(r.offsets),
                   bool(r.overflow)) for r in results]


def match_config(config: dict):
    """The port's ``MatchConfig`` with the configuration file's fields."""
    return port_module("utils.config").MatchConfig(
        **config.get("match_config", {}))


def pool(config: dict, text: torch.Tensor, n: int, seed: int,
         root=None) -> list:
    """The pool's items, each a tuple of patterns: the recipe's ``fixed``
    patterns, then ``slices`` slices, item i's ``lengths[i % len(lengths)]``
    bytes long.  The slices are cut at offsets drawn from the run's seed
    out of the run's corpus, or, where the recipe gives a ``sample``, out
    of a sample of that many bytes made by the corpus's generator from the
    recipe's own seed: the same patterns in every run, so the seed changes
    the corpus and the order but not how much work a pattern makes."""
    rec = config["patterns"]
    sample = rec.get("sample")
    if sample:
        seed = rec["sample_seed"]
        n = sample
        text = corpus.make(config["corpus"]["kind"], n, n, seed, text.device,
                           root)
    rng = np.random.default_rng(int(seed) & (2**64 - 1))
    fixed = tuple(p.encode() for p in rec.get("fixed", ()))
    items = []
    for i in range(rec["pool"]):
        m = rec["lengths"][i % len(rec["lengths"])]
        offs = torch.from_numpy(rng.integers(0, n - m + 1, size=rec["slices"]))
        rows = text[(offs[:, None] + torch.arange(m)).to(text.device)].cpu()
        items.append(fixed + tuple(r.numpy().tobytes() for r in rows))
    return items


def padded_length(config: dict, n: int) -> int:
    """n rounded up as the port's ``match`` pads a text of n bytes for
    this configuration's matcher."""
    cls = port_module().get_matcher(config["algorithm"])
    cfg = match_config(config)
    mult = port_module("models.base").pad_target(n, cfg, cls._tile_bytes(cfg))
    return -(-n // mult) * mult


class Passes:
    """Which pool item query i takes: the pool in passes, each in a new
    order drawn from the seed, so every item is taken as often as any
    other."""

    def __init__(self, size: int, seed: int):
        self.size, self.perm = size, list(range(size))
        self.rng = random.Random(int(seed) * 2 + 1)

    def next(self, i: int) -> int:
        if i % self.size == 0:
            self.rng.shuffle(self.perm)
        return self.perm[i % self.size]


class Sample:
    """The answers kept for the check: each pool item's first, and a
    sample of ``size`` of all of them drawn from the seed whatever the
    number of queries (reservoir sampling).  A kept answer keeps only its
    valid offsets, not the capacity-wide buffer they were read from."""

    def __init__(self, size: int, seed: int):
        self.size, self.first, self.drawn = size, {}, []
        self.rng = random.Random(int(seed) * 2)

    @staticmethod
    def _compact(answers) -> list:
        return [dataclasses.replace(a, offsets=a.offsets.copy())
                for a in answers]

    def offer(self, i: int, item: int, answers) -> None:
        if item not in self.first:
            self.first[item] = self._compact(answers)
        if i < self.size:
            self.drawn.append((item, self._compact(answers)))
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.drawn[j] = (item, self._compact(answers))

    @property
    def kept(self) -> list:
        return list(self.first.items()) + self.drawn


class Entry:
    """One cell's side of the port: the corpus made on ``device`` from the
    seed and padded as ``match`` pads it, the pool, and the
    ``MatchConfig``.  A subclass gives ``query(k)``; ``warm`` runs every
    item once, so the window meets no shape that set-up did not."""

    def __init__(self, config: dict, seed: int, device: torch.device,
                 n: int, root=None):
        self.config, self.device, self.n = config, device, n
        self.port, self.api = port_module(), port_module("api")
        self.base = port_module("models.base")
        self.multi = bool(config.get("multi"))
        self.algo = config["algorithm"]
        self.text = corpus.make(config["corpus"]["kind"], n,
                                padded_length(config, n), seed, device, root)
        self.items = pool(config, self.text, n, seed, root)
        self.cfg = match_config(config)

    def query(self, k: int) -> list:
        raise NotImplementedError

    def warm(self) -> None:
        for k in range(len(self.items)):
            self.query(k)

    def matcher(self, k: int):
        """Item k's matcher, from the port's cache as ``match`` takes it."""
        items, cfg = self.items[k], self.cfg
        if self.multi:
            return self.api.cached_matcher(self.port.RabinKarpMultiMatcher,
                                           items, cfg, self.device)
        return self.api.cached_matcher(self.api.get_matcher(self.algo),
                                       items[0], cfg, self.device)

    def free(self) -> None:
        """Drop what the port holds for this entry (its matchers)."""
        self.api._matcher_cache.clear()
