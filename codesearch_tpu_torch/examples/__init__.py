"""Runnable studies of the port (``python -m codesearch_tpu_torch.examples.<name>``)."""
