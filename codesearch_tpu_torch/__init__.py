"""codesearch_tpu_torch: the PyTorch / CUDA port of codesearch_tpu.

Runs index -> hybrid search on one NVIDIA GPU (or on the CPU when asked for
explicitly). The JAX package ``codesearch_tpu`` stays the reference: every
module here keeps the path and function names of its counterpart there,
host-only modules (chunker, file walking, persistence, query analysis,
fusion) included, which the port keeps as copies of its own. Both packages
read and write one on-disk index format. This package imports neither
``jax`` nor ``codesearch_tpu``.
"""

import torch

__version__ = "0.1.0"

# The BM25 dense leg's ``pw @ planes`` product must sum in full float32, as
# the JAX package's does: its exactness argument compares f32 sums. TF32 is
# torch's default off; it is set once here in case a caller turned it on.
torch.backends.cuda.matmul.allow_tf32 = False
