"""Port-local utilities (the host utilities are imported from codesearch_tpu.utils)."""
