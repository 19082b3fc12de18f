"""flink_ms_tpu_torch — the PyTorch/CUDA port of ``flink_ms_tpu``.

The JAX package ``flink_ms_tpu`` stays the reference; this package mirrors
its layout so each module sits where its counterpart does, imports
``torch`` and numpy only, and runs its hand-written CUDA kernels on an
NVIDIA Hopper card (``csrc/``).  Importing the package imports nothing.

Package layout
--------------
core/      flags and the text-format contracts (own copies)
parallel/  device selection (one card)
ops/       blocked ALS, the batched Cholesky solve and bucket assembly;
           CoCoA SVM, its round-boundary margin gather and Δw scatter-add
csrc/      CUDA C++ sources of the kernels, built with nvcc at first use
train/     the ALS and SVM training CLIs
serve/     the model table, the top-k index with its IVF tier, the batcher
eval/      offline MSE evaluation
obs/       the metrics the serving path records
utils/     step timing and profiler traces
"""

__version__ = "0.1.0"
