"""codesearch_tpu_torch: the PyTorch / CUDA port of codesearch_tpu.

Runs the default ``code-hash-384`` index -> hybrid search path on one
NVIDIA GPU (or on the CPU when asked for explicitly). The JAX package
``codesearch_tpu`` stays the reference: host-only modules (chunker, file
walking, persistence, query analysis, fusion) are imported from it, and
every module here that has a JAX counterpart keeps its path and function
names. This package never imports ``jax``.
"""

import importlib.util
import sys
import types

import torch

__version__ = "0.1.0"


def _host_package() -> None:
    """Register ``codesearch_tpu`` as a bare package so that its host-only
    submodules import without its ``__init__``, whose one job is to import
    JAX and set up JAX's compilation cache. Where the JAX package was
    imported first (its tests, a process that uses both), it is left as is.
    """
    if "codesearch_tpu" in sys.modules:
        return
    spec = importlib.util.find_spec("codesearch_tpu")
    if spec is None or spec.submodule_search_locations is None:
        raise ImportError("codesearch_tpu_torch needs the codesearch_tpu package beside it")
    pkg = types.ModuleType("codesearch_tpu", "host modules of the JAX package")
    pkg.__path__ = list(spec.submodule_search_locations)
    pkg.__file__ = spec.origin
    pkg.__version__ = __version__   # read by the shared CLI parser's --version
    sys.modules["codesearch_tpu"] = pkg


_host_package()

# The BM25 dense leg's ``pw @ planes`` product must sum in full float32, as
# the JAX package's does: its exactness argument compares f32 sums. TF32 is
# torch's default off; it is set once here in case a caller turned it on.
torch.backends.cuda.matmul.allow_tf32 = False
