"""Counterpart of ``flink_ms_tpu.ops``: blocked ALS and its two kernels.

TF32 is turned off here, on import of the ops, for matrix products and
cuDNN alike.  The reference assembles the normal equations at HIGHEST
precision (``flink_ms_tpu/ops/als.py:75-78``, ``:609-621``); a float32
product in TF32 keeps about three decimal digits, which would break parity
with it silently.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
