"""Matching over many chunks, ranks and hosts (counterpart of the JAX
package's ``parallel/``)."""

from .dist import DistributedMatcher, DistributedMultiMatcher  # noqa: F401
from .mesh import DataMesh, make_data_mesh  # noqa: F401
from .multihost import match_multihost, match_multihost_streaming  # noqa: F401
from .streaming import StreamingMatcher, match_stream  # noqa: F401
