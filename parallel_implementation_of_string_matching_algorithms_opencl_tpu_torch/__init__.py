"""PyTorch + CUDA port of the tpumatch exact string-matching framework.

The JAX package ``parallel_implementation_of_string_matching_algorithms_opencl_tpu``
is the reference this package is held against; this one imports ``torch``
and never ``jax``.  It has single-device ``match()`` (with ``drain``) for
all four algorithms, naive, Rabin-Karp, KMP and Boyer-Moore, of one pattern
or a list of them (multi-pattern Rabin-Karp shares one hash pass per group
of equal-length patterns), every opt-in mode of ``MatchConfig``,
``match_stream`` (``parallel/streaming.py``: a file in fixed-shape chunks
with resume and drain), and the sharded paths over a ``torch.distributed``
process group, one rank per device (NCCL on the card, gloo on the CPU):
``match_distributed`` (``parallel/dist.py``: shards with halos from the
neighbouring ranks) and ``match_multihost`` / ``match_multihost_streaming``
(``parallel/multihost.py``: each rank's slice of a shared file).  The scans run on hand-written CUDA kernels for
Hopper, K1-K11d, five ``__global__`` templates in ``csrc/``.  Around them:
the command line ``cli.py`` (the repo's ``cli.py`` on the port: ``python
-m <package>.cli`` or ``tpumatch-torch``; ``--distributed`` is one rank per
device under ``torchrun``), ``utils/profiling.py`` (``torch.profiler``
traces, the pipelined ``timed``, ``device_stats`` and the card's timers)
and ``utils/native.py`` (the binding to ``native/``'s serial baselines,
tables and chunk reader).
The output contract is the reference's: the exact count, the sorted 0-based
byte offsets of every overlapping match up to ``capacity``, an overflow
flag, and every offset with ``drain=True``.
"""

from .api import MatchResult, available_algorithms, match, match_distributed
from .models.base import Matcher
from .models.multi import RabinKarpMultiMatcher
from .models.registry import get_matcher, register_matcher
from .parallel.dist import DistributedMatcher, DistributedMultiMatcher
from .parallel.multihost import match_multihost, match_multihost_streaming
from .parallel.streaming import StreamingMatcher, match_stream
from .utils.config import MatchConfig

__version__ = "0.1.0"

__all__ = [
    "match",
    "match_distributed",
    "match_multihost",
    "match_multihost_streaming",
    "match_stream",
    "MatchResult",
    "Matcher",
    "DistributedMatcher",
    "DistributedMultiMatcher",
    "RabinKarpMultiMatcher",
    "StreamingMatcher",
    "MatchConfig",
    "get_matcher",
    "register_matcher",
    "available_algorithms",
    "__version__",
]
