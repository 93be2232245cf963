"""dynavsr_tpu_torch — the PyTorch/CUDA (H100) port of dynavsr_tpu.

Mirrors the JAX package's layout (ops/, models/, adapt/, data/, eval/,
train/, convert/, cli/). Imports torch, never jax: the modules it needs
from the JAX package are copied, not imported. The deformable conv, the
flow warp and DUF's dynamic upsampling filter, forward and backward, are
hand-written CUDA kernels (csrc/); every other op is plain PyTorch.
"""

from dynavsr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
