"""Algorithm registry: name -> Matcher class (plus aliases)."""

from __future__ import annotations

from .base import Matcher

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
