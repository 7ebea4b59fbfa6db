"""PyTorch + CUDA port of the tpumatch exact string-matching framework.

The JAX package ``parallel_implementation_of_string_matching_algorithms_opencl_tpu``
is the reference this package is held against; this one imports ``torch``
and never ``jax``.  It has single-device ``match()`` (with ``drain``) for
all four algorithms, naive, Rabin-Karp, KMP and Boyer-Moore, of one pattern
or a list of them (multi-pattern Rabin-Karp shares one hash pass per group
of equal-length patterns), every opt-in mode of ``MatchConfig``, and
``match_stream`` (``parallel/streaming.py``: a file in fixed-shape chunks
with resume and drain).  The scans run on hand-written CUDA kernels for
Hopper, K1-K11d, five ``__global__`` templates in ``csrc/``.
The output contract is the reference's: the exact count, the sorted 0-based
byte offsets of every overlapping match up to ``capacity``, an overflow
flag, and every offset with ``drain=True``.
"""

from .api import MatchResult, available_algorithms, match
from .models.base import Matcher
from .models.multi import RabinKarpMultiMatcher
from .models.registry import get_matcher, register_matcher
from .parallel.streaming import StreamingMatcher, match_stream
from .utils.config import MatchConfig

__version__ = "0.1.0"

__all__ = [
    "match",
    "match_stream",
    "MatchResult",
    "Matcher",
    "RabinKarpMultiMatcher",
    "StreamingMatcher",
    "MatchConfig",
    "get_matcher",
    "register_matcher",
    "available_algorithms",
    "__version__",
]
