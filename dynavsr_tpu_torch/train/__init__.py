"""Training pieces the adaptation loop needs (the loss)."""
