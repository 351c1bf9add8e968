"""Training on torch (port of ``codesearch_tpu/train/``): contrastive steps
of any registry encoder, the hash table's fine-tuning and the local
cross-encoder, with checkpoints. The JAX package's mesh shardings
(``param_shardings``, ``_rule_for``) wait for ``parallel/``; the port trains
on one device."""

from .contrastive import (  # noqa: F401
    info_nce_loss,
    make_train_state,
    make_train_step,
)
