"""Algorithm registry: name -> Matcher class (plus aliases), and the
matcher cache the entry points share."""

from __future__ import annotations

from .base import Matcher, resolve_device

_REGISTRY: dict[str, type[Matcher]] = {}
_ALIASES = {
    "bm": "boyer_moore",
    "rk": "rabin_karp",
    "brute": "naive",
}


def register_matcher(cls: type[Matcher]) -> type[Matcher]:
    _REGISTRY[cls.name] = cls
    return cls


def get_matcher(name: str) -> type[Matcher]:
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown algorithm {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[key]


def available_algorithms() -> list[str]:
    return sorted(_REGISTRY)


_matcher_cache: dict = {}


def cached_matcher(cls, pattern, config, device):
    """``cls(pattern, config, device)``, built once per (matcher, pattern or
    patterns, config, device), so repeated calls reuse its device tables;
    ``pattern`` is bytes, or a tuple of bytes for ``RabinKarpMultiMatcher``."""
    dev = resolve_device(device)
    key = (cls.name, pattern, config, str(dev))
    m = _matcher_cache.get(key)
    if m is None:
        m = _matcher_cache[key] = cls(pattern, config, dev)
    return m
