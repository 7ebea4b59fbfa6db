"""Matching over many chunks (counterpart of the JAX package's ``parallel/``)."""

from .streaming import StreamingMatcher, match_stream  # noqa: F401
