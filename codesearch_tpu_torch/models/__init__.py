"""Models: the weights-free hash embedder."""
