"""Multi-device parallelism: the serving mesh (a device list in one process)
and sharded corpus search; the training mesh over ``torch.distributed``
(``train_mesh``) and its single-host launcher (``launch``)."""

from .mesh import make_mesh  # noqa: F401
from .sharded_search import sharded_cosine_topk  # noqa: F401
