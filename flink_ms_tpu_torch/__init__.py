"""flink_ms_tpu_torch — the PyTorch/CUDA port of ``flink_ms_tpu``.

The JAX package ``flink_ms_tpu`` stays the reference; this package mirrors
its layout so each module sits where its counterpart does, imports
``torch`` and numpy only, and runs its hand-written CUDA kernels on an
NVIDIA Hopper card (``csrc/``).  Importing the package imports nothing.

Package layout
--------------
core/      flags and the text-format contracts (own copies)
parallel/  device selection (one card, one block)
ops/       blocked ALS, the batched Cholesky solve and bucket assembly
csrc/      CUDA C++ sources of the kernels, built with nvcc at first use
train/     the ALS training CLI
utils/     step timing and profiler traces
"""

__version__ = "0.1.0"
