"""Training on torch (port of ``codesearch_tpu/train/``): contrastive steps
of any registry encoder, on one device or over a ("data", "model") training
mesh (``parallel.train_mesh``: the JAX package's ``param_shardings`` and
``_rule_for``), the hash table's fine-tuning and the local cross-encoder,
with checkpoints that a mesh of any shape restores."""

from .contrastive import (  # noqa: F401
    info_nce_loss,
    make_sharded_train_state,
    make_train_state,
    make_train_step,
    param_shardings,
)
