"""Top-level user API (counterpart of the JAX package's ``api.py``).

``match(text, pattern)`` is the single-device entry point; a list of
patterns returns one result per pattern.  ``match_distributed`` shards the
text over the ranks of a process group with halo overlap.  Matchers are
cached per (matcher, pattern or patterns, config, device), so repeated
calls reuse their device tables.
"""

from __future__ import annotations

from .models.base import MatchResult
from .models.multi import RabinKarpMultiMatcher
from .models.registry import (  # noqa: F401  (_matcher_cache: the shared cache)
    _matcher_cache,
    available_algorithms,
    cached_matcher,
    get_matcher,
)
from .utils.config import DEFAULT_CONFIG, MatchConfig


def _coerce_pattern(pattern) -> bytes:
    if isinstance(pattern, str):
        return pattern.encode("utf-8")
    return bytes(pattern)


def match(
    text,
    pattern,
    algo: str = "boyer_moore",
    config: MatchConfig | None = None,
    drain: bool = False,
    device="cuda",
    **overrides,
):
    """Exact match: all (overlapping) occurrences as sorted 0-based byte
    offsets, with the exact count.  ``algo``: ``naive`` (``brute``),
    ``rabin_karp`` (``rk``), ``kmp`` or ``boyer_moore`` (``bm``); all four
    return the same result.

    ``pattern`` may be bytes or str, or a list of them: a list returns a
    list of ``MatchResult`` in input order.  With ``algo='rabin_karp'``
    each group of two or more equal-length patterns shares one hash pass
    (``RabinKarpMultiMatcher``); otherwise each pattern runs on its own.

    ``drain=True`` returns every offset even past ``capacity`` (windowed
    re-extraction, ``Matcher.match_all``).  ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent; ``device="cpu"`` runs the
    kernels' plain PyTorch versions.
    """
    cfg = (config or DEFAULT_CONFIG).replace(**overrides) if overrides else (
        config or DEFAULT_CONFIG
    )
    if isinstance(pattern, (list, tuple)):
        return _match_many(text, [_coerce_pattern(p) for p in pattern], algo,
                           cfg, drain, device)
    m = cached_matcher(get_matcher(algo), _coerce_pattern(pattern), cfg,
                       device)
    return m.match_all(text) if drain else m.match(text)


def _match_many(text, patterns: list[bytes], algo: str, cfg: MatchConfig,
                drain: bool, device) -> list[MatchResult]:
    cls = get_matcher(algo)

    def one(p: bytes) -> MatchResult:
        m = cached_matcher(cls, p, cfg, device)
        return m.match_all(text) if drain else m.match(text)

    if cls.name != "rabin_karp" or drain:
        # drain=True runs per pattern, so the windowed re-extraction
        # guarantee holds for every pattern.
        return [one(p) for p in patterns]
    by_len: dict[int, list[int]] = {}
    for i, p in enumerate(patterns):
        by_len.setdefault(len(p), []).append(i)
    results: list[MatchResult | None] = [None] * len(patterns)
    for idxs in by_len.values():
        if len(idxs) == 1:
            results[idxs[0]] = one(patterns[idxs[0]])
            continue
        mm = cached_matcher(RabinKarpMultiMatcher,
                            tuple(patterns[i] for i in idxs), cfg, device)
        for i, r in zip(idxs, mm.match(text)):
            results[i] = r
    return results


def match_distributed(
    text,
    pattern,
    algo: str = "boyer_moore",
    config: MatchConfig | None = None,
    mesh=None,
    drain: bool = False,
    device=None,
    **overrides,
):
    """Sharded match over a process group, one rank per device, with
    (m-1)-byte halos (see ``parallel/dist.py``).  Every rank of the group
    calls it with the same text and gets the same result; without a group
    the mesh is one rank.  ``mesh`` defaults to
    ``make_data_mesh(device=device)``: the default group and the rank's
    CUDA device, which raises without CUDA; ``device="cpu"`` runs the plain
    versions (gloo for a group).

    ``pattern`` may be a list: with ``algo='rabin_karp'`` each group of two
    or more equal-length patterns shares one hash pass per shard
    (``DistributedMultiMatcher``); otherwise one sharded run per pattern.
    A list returns a list of MatchResult in input order.

    ``drain=True`` returns every offset even past per-shard capacity: each
    rank re-extracts its own incomplete shard (``match_all``); counts are
    exact either way.
    """
    from .parallel.dist import DistributedMatcher, DistributedMultiMatcher
    from .parallel.mesh import make_data_mesh

    cfg = (config or DEFAULT_CONFIG).replace(**overrides) if overrides else (
        config or DEFAULT_CONFIG
    )
    if mesh is None:
        mesh = make_data_mesh(device=device)

    def run(dm):
        return dm.match_all(text) if drain else dm.match(text)

    def single(p: bytes):
        return run(DistributedMatcher(p, algo=algo, config=cfg, mesh=mesh))

    if not isinstance(pattern, (list, tuple)):
        return single(_coerce_pattern(pattern))
    patterns = [_coerce_pattern(p) for p in pattern]
    if get_matcher(algo).name != "rabin_karp":
        return [single(p) for p in patterns]
    by_len: dict[int, list[int]] = {}
    for i, p in enumerate(patterns):
        by_len.setdefault(len(p), []).append(i)
    results: list[MatchResult | None] = [None] * len(patterns)
    for idxs in by_len.values():
        if len(idxs) == 1:
            results[idxs[0]] = single(patterns[idxs[0]])
            continue
        dm = DistributedMultiMatcher([patterns[i] for i in idxs], config=cfg,
                                     mesh=mesh)
        for i, r in zip(idxs, run(dm)):
            results[i] = r
    return results


__all__ = ["match", "match_distributed", "MatchResult", "available_algorithms"]
