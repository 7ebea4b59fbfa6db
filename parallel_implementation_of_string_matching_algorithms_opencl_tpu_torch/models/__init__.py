"""Matcher models.  Importing the algorithms module registers them."""

from . import algorithms  # noqa: F401
