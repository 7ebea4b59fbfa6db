"""Top-level user API (counterpart of the JAX package's ``api.py``).

``match(text, pattern)`` is the single-device entry point.  Matchers are
cached per (algo, pattern, config, device), so repeated calls reuse their
device tables.
"""

from __future__ import annotations

from .models.base import Matcher, MatchResult, resolve_device
from .models.registry import available_algorithms, get_matcher
from .utils.config import DEFAULT_CONFIG, MatchConfig

_matcher_cache: dict = {}


def _get_cached_matcher(algo: str, pattern: bytes, config: MatchConfig,
                        device) -> Matcher:
    dev = resolve_device(device)
    key = (algo, pattern, config, str(dev))
    m = _matcher_cache.get(key)
    if m is None:
        m = get_matcher(algo)(pattern, config, dev)
        _matcher_cache[key] = m
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
) -> MatchResult:
    """Exact match: all (overlapping) occurrences as sorted 0-based byte
    offsets, with the exact count.  ``algo``: ``naive`` (``brute``),
    ``rabin_karp`` (``rk``), ``kmp`` or ``boyer_moore`` (``bm``); all four
    return the same result.

    ``drain=True`` returns every offset even past ``capacity`` (windowed
    re-extraction, ``Matcher.match_all``).  ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent; ``device="cpu"`` runs the
    kernels' plain PyTorch versions.
    """
    cfg = (config or DEFAULT_CONFIG).replace(**overrides) if overrides else (
        config or DEFAULT_CONFIG
    )
    if isinstance(pattern, (list, tuple)):
        raise NotImplementedError(
            "a list of patterns (multi-pattern matching) is not ported to "
            "the PyTorch package yet (ROADMAP.md, Queue 1 item 7)"
        )
    m = _get_cached_matcher(algo, _coerce_pattern(pattern), cfg, device)
    return m.match_all(text) if drain else m.match(text)


__all__ = ["match", "MatchResult", "available_algorithms"]
