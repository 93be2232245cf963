"""Ops: the deformable conv (CUDA kernels + plain version) and pixel shuffle."""
