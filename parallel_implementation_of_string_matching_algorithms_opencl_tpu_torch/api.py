"""Top-level user API (counterpart of the JAX package's ``api.py``).

``match(text, pattern)`` is the single-device entry point; a list of
patterns returns one result per pattern.  Matchers are cached per (matcher,
pattern or patterns, config, device), so repeated calls reuse their device
tables.
"""

from __future__ import annotations

from .models.base import MatchResult, resolve_device
from .models.multi import RabinKarpMultiMatcher
from .models.registry import available_algorithms, get_matcher
from .utils.config import DEFAULT_CONFIG, MatchConfig

_matcher_cache: dict = {}


def _get_cached_matcher(cls, pattern, config: MatchConfig, device):
    """``cls(pattern, config, device)``, built once per key; ``pattern`` is
    bytes, or a tuple of bytes for ``RabinKarpMultiMatcher``."""
    dev = resolve_device(device)
    key = (cls.name, pattern, config, str(dev))
    m = _matcher_cache.get(key)
    if m is None:
        m = _matcher_cache[key] = cls(pattern, config, dev)
    return m


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
    m = _get_cached_matcher(get_matcher(algo), _coerce_pattern(pattern), cfg,
                            device)
    return m.match_all(text) if drain else m.match(text)


def _match_many(text, patterns: list[bytes], algo: str, cfg: MatchConfig,
                drain: bool, device) -> list[MatchResult]:
    cls = get_matcher(algo)

    def one(p: bytes) -> MatchResult:
        m = _get_cached_matcher(cls, p, cfg, device)
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
        mm = _get_cached_matcher(RabinKarpMultiMatcher,
                                 tuple(patterns[i] for i in idxs), cfg, device)
        for i, r in zip(idxs, mm.match(text)):
            results[i] = r
    return results


__all__ = ["match", "MatchResult", "available_algorithms"]
