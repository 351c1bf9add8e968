"""Multi-device parallelism: the device mesh and sharded corpus search."""

from .mesh import make_mesh  # noqa: F401
from .sharded_search import sharded_cosine_topk  # noqa: F401
