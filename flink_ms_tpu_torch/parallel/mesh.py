"""Device selection and the port's mesh: D ranks of a process group.

Counterpart of ``flink_ms_tpu/parallel/mesh.py``.  The JAX package spreads
the ALS blocks and the SVM chains over a 1-D device mesh; the port runs one
process per GPU (``parallel/distributed.py``), so its mesh is the process
group: D = the number of ranks, block d = rank d, and a process outside a
group is a mesh of one.  Every ALS solve is exact per row, so D does not
change the result beyond the order of float sums
(``flink_ms_tpu/train/als_train.py:62-66``); K SVM chains are padded to a
multiple of D and split C = K/D a rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from .distributed import in_group, world_size


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


def local_device(device="cuda") -> torch.device:
    """The device this process computes on: ``resolve_device(device)``,
    with a bare ``"cuda"`` pinned to the GPU the rank was given
    (``torch.cuda.set_device``: its local rank, as ``launch_local`` and
    ``maybe_init_distributed`` set it)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def num_blocks() -> int:
    """D: the ranks of the process group, or 1 outside one."""
    return world_size()


def visible_devices(device="cuda") -> int:
    """The devices of ``device``'s platform this process can see: the
    visible GPUs, or one CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def ranks_for_blocks(blocks: Optional[int], n_devices: Optional[int] = None,
                     device="cuda") -> int:
    """The ranks D for a ``--blocks``/``--devices`` request: the
    counterpart of the reference's ``mesh_for_blocks``.

    - in a process group, D is its size (a rank cannot leave its group;
      a ``--devices`` that differs raises);
    - an explicit ``--devices`` wins (on cuda, at most the visible GPUs;
      CPU ranks are processes, any number);
    - ``blocks <= devices``: exactly ``blocks`` ranks;
    - ``blocks > devices``: every device, and the logical blocks run on
      them (the SVM stacks ceil(K/D) chains a rank; the ALS solve is
      row-exact), with the reference's line printed."""
    avail = visible_devices(device)
    if in_group():
        if n_devices is not None and n_devices != world_size():
            raise ValueError(
                f"--devices {n_devices} in a process group of "
                f"{world_size()} ranks")
        return world_size()
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"--devices must be >= 1, got {n_devices}")
        if torch.device(device).type == "cuda" and n_devices > avail:
            raise ValueError(f"requested {n_devices} devices but only "
                             f"{avail} available")
        return n_devices
    if blocks is None:
        return avail
    if blocks > avail:
        print(
            f"[mesh] --blocks {blocks} exceeds the {avail} visible "
            f"device(s); running the logical blocks on {avail} device "
            "block(s) (SVM stacks chains per device; ALS partitioning is "
            "row-exact)"
        )
    return max(min(blocks, avail), 1)


def row_bucket(n: int, n_shards: int, floor: int = 8) -> int:
    """Pad a row count to the next power-of-two PER-SHARD bucket: the
    padded total is ``n_shards * 2^ceil(log2(ceil(n / n_shards)))``, every
    shard holds the same power-of-two row count, and a catalog that grows
    row by row sees a handful of shapes.  ``floor`` bounds the per-shard
    size from below so tiny catalogs still give each shard enough rows for
    a local top-k.  Copied from the reference."""
    if n_shards < 1:
        raise ValueError("need n_shards >= 1")
    per_shard = max((max(n, 1) + n_shards - 1) // n_shards, floor)
    return n_shards * (1 << (per_shard - 1).bit_length())
