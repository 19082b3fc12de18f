"""Device selection for the port.

Counterpart of ``flink_ms_tpu/parallel/mesh.py``.  The JAX package spreads
the ALS blocks and the SVM chains over a 1-D device mesh; the port runs on
one card, D = 1.  Every ALS solve is exact per row, so on one card the
result does not depend on D (``flink_ms_tpu/train/als_train.py:62-66``);
all K SVM chains run on the one card.  Multi-GPU training is later work
(ROADMAP.md).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, after checking that it can run.

    There is no fallback: a CUDA device on a host without CUDA raises, and
    the caller passes ``"cpu"`` to run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but CUDA is not "
                "available here; pass device='cpu' (CLI: --device cpu) to "
                "run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (use cuda|cpu)")
    return dev


def num_blocks() -> int:
    """Devices of the port's mesh, D: one card holds one ALS block and
    every SVM chain."""
    return 1

