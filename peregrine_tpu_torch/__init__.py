"""peregrine_tpu_torch — the PyTorch and CUDA port of peregrine_tpu.

The JAX package beside it is the reference this port is held against.
This package imports torch and numpy and never jax: its stage outputs are
byte-identical to the JAX package's, its host modules are copies of the
JAX package's numpy code, and the SHIMMER index kernels are CUDA C++ for
Hopper (csrc/shimmer_kernels.cu), each beside a plain PyTorch version.
Functions take an explicit device; nothing here keeps global state.
"""

__version__ = "0.1.0"
