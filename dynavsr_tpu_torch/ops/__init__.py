"""Ops: the deformable conv, the flow warp and DUF's dynamic upsampling
filter (CUDA kernels + plain versions), and pixel shuffle."""
