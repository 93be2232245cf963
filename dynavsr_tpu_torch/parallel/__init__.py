"""Multi-device runs over torch.distributed (port of dynavsr_tpu/parallel/)."""
