"""Training pieces the serving path needs: the loss and network checkpoints."""
