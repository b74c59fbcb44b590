"""repro_torch — the Heteroflow runtime and its serving path in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (``kernels/csrc``).

The JAX package ``repro`` is the reference this port is held against;
this package imports neither it nor JAX.  Entry points run on CUDA
unless the caller passes a CPU device.
"""
__version__ = "1.0.0"
