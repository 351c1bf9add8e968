"""Cross-cutting utilities: constants, errors, output control, logging,
hashing (copies of the JAX package's host modules), and device selection."""
