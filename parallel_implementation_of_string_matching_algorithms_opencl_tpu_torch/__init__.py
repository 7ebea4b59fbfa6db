"""PyTorch + CUDA port of the tpumatch exact string-matching framework.

The JAX package ``parallel_implementation_of_string_matching_algorithms_opencl_tpu``
is the reference this package is held against; this one imports ``torch``
and never ``jax``.  Ported so far: single-pattern Boyer-Moore ``match()``
(with ``drain``), on two hand-written CUDA kernels for Hopper (``csrc/``).
The output contract is the reference's: the exact count, the sorted 0-based
byte offsets of every overlapping match up to ``capacity``, an overflow
flag, and every offset with ``drain=True``.
"""

from .api import MatchResult, available_algorithms, match
from .models.base import Matcher
from .models.registry import get_matcher, register_matcher
from .utils.config import MatchConfig

__version__ = "0.1.0"

__all__ = [
    "match",
    "MatchResult",
    "Matcher",
    "MatchConfig",
    "get_matcher",
    "register_matcher",
    "available_algorithms",
    "__version__",
]
