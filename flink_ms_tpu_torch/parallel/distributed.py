"""Multi-process runs over ``torch.distributed``: one process per GPU.

Counterpart of ``flink_ms_tpu/parallel/distributed.py``.  The reference
joins N processes with ``jax.distributed`` and lets one mesh span every
process's devices; the port runs one process per GPU (a *rank*), each
holding one block of the ALS factors or one share of the SVM chains, and
the reference's ``all_gather`` / ``all_to_all`` / ``psum`` inside
``shard_map`` become ``torch.distributed`` collectives.  NCCL carries CUDA
tensors, gloo carries CPU tensors (and CUDA tensors, through host memory,
where asked for by name).

Flags, the reference's control-plane flags:

  --coordinatorAddress host:port   rank 0's endpoint (``tcp://`` implied;
                                   a ``file://`` path also works)
  --numProcesses N                 the number of ranks
  --processId I                    this process's rank in [0, N)
  --backend nccl|gloo              default: nccl on cuda, gloo on cpu

The environment names ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID`` serve as fallbacks, so one launcher drives both
packages, and so do torch's own ``MASTER_ADDR`` + ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK``.  The backend is never switched on its own: a
failed NCCL init raises.

``launch_local`` starts the ranks of a job on this host (the CLIs'
``--devices N``): spawned processes that meet at a ``file://``
rendezvous in a temporary directory.  The function a rank runs must be
importable from the port, since a spawned child imports it by name.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.params import Params


def _flag_or_env(params: Optional[Params], flag: str, *envs: str):
    if params is not None:
        v = params.get(flag)
        if v is not None:
            return str(v)
    for env in envs:
        if os.environ.get(env):
            return os.environ[env]
    return None


def in_group() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def default_backend(device) -> str:
    """nccl for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(params: Optional[Params] = None) -> bool:
    """Join the process group that the flags (or the environment) name.

    -> True when this process is a rank of a group, now or from before;
    False for a plain single-process run.  Idempotent: every CLI calls it.
    On ``--device cuda`` the rank takes its local GPU (``LOCAL_RANK``, else
    its rank modulo the visible GPUs) before the group starts."""
    if in_group():
        return True
    coordinator = _flag_or_env(params, "coordinatorAddress",
                               "JAX_COORDINATOR_ADDRESS")
    if not coordinator and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if not coordinator:
        return False
    n = _flag_or_env(params, "numProcesses", "JAX_NUM_PROCESSES",
                     "WORLD_SIZE")
    pid = _flag_or_env(params, "processId", "JAX_PROCESS_ID", "RANK")
    if n is None or pid is None:
        raise ValueError(
            "--coordinatorAddress requires --numProcesses and --processId "
            "(or JAX_NUM_PROCESSES / JAX_PROCESS_ID)"
        )
    n, pid = int(n), int(pid)
    device = torch.device(params.get("device", "cuda") if params is not None
                          else "cuda")
    backend = _flag_or_env(params, "backend") or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--backend {backend!r} must be nccl|gloo")
    if device.type == "cuda":
        from .mesh import resolve_device

        resolve_device(device)  # no CUDA here: raise, never fall back
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else pid % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=pid)
    return True


@contextlib.contextmanager
def joined_group(params: Optional[Params] = None):
    """``maybe_init_distributed`` for a CLI's whole run: a group that this
    call joins ends as ``launch_local``'s ranks end theirs, with a barrier
    after a run that returned and ``destroy_process_group`` on every path.
    A process already in a group (a spawned rank) keeps it."""
    joined = not in_group() and maybe_init_distributed(params)
    try:
        yield
        if joined:
            dist.barrier()
    finally:
        if joined:
            dist.destroy_process_group()


def is_primary() -> bool:
    """True on the rank that owns side effects (file writes): the
    reference's one process that materialises a job's output."""
    return rank() == 0


def gather_blocks(t: torch.Tensor) -> torch.Tensor:
    """Every rank's block of a block-sharded table, stacked in rank order
    (= block order) on this rank's device: one ``all_gather`` of the
    leading axis.  Outside a process group, ``t`` itself."""
    if not in_group():
        return t
    t = t.contiguous()
    out = t.new_empty((world_size() * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (the reference's ``psum``);
    outside a process group, ``t``."""
    if in_group():
        dist.all_reduce(t)
    return t


def _comm_device() -> torch.device:
    """Where a host value travels for a collective: NCCL moves CUDA
    tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_one_to_all(x) -> np.ndarray:
    """Rank 0's value of a host array on every rank.  Every rank passes an
    array of the same shape and dtype (its own value is discarded)."""
    x = np.ascontiguousarray(x)
    if not in_group():
        return x
    t = torch.from_numpy(x.copy()).to(_comm_device())
    dist.broadcast(t, 0)
    return t.cpu().numpy()


def run_calls(calls) -> list:
    """Make several calls in order -> their values: the job of ranks that
    ``launch_local`` starts once for several fits (a rank costs seconds to
    start: an interpreter and torch).  Each call is ``(fn, args, kwargs,
    env)``; ``env``, a dict or None, is set in ``os.environ`` around its
    call (the ops read their modes from the environment) and restored."""
    values = []
    for fn, args, kwargs, env in calls:
        saved = {key: os.environ.get(key) for key in env or {}}
        os.environ.update(env or {})
        try:
            values.append(fn(*args, **kwargs))
        finally:
            for key, value in saved.items():
                if value is None:
                    del os.environ[key]
                else:
                    os.environ[key] = value
    return values


def _rank_main(rank_, world, init, backend, device, fn, args, kwargs,
               results):
    """One spawned rank: take the device, join the group, run ``fn``,
    report its value (or the traceback) to the parent."""
    try:
        kw = {}
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
            if backend == "nccl":  # bind the communicator to the rank's GPU
                kw["device_id"] = torch.device(device)
        else:
            # CPU ranks share the host's cores instead of each taking all
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank_, **kw)
        try:
            value = fn(*args, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, value))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank_, False, traceback.format_exc()))


def launch_local(fn, world: int, args: tuple = (),
                 kwargs: Optional[dict] = None, *, device="cuda",
                 backend: Optional[str] = None,
                 devices: Optional[Sequence] = None,
                 timeout: float = 900.0) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world`` ranks of this host -> each
    rank's return value, in rank order.

    Every rank is a process started with the ``spawn`` method; the ranks
    meet at a ``file://`` rendezvous in a fresh temporary directory, so
    concurrent jobs never share an address.  On ``device="cuda"`` (the
    default) rank r takes ``devices[r]`` (default ``cuda:r``) before its
    group starts; ``device="cpu"`` runs CPU ranks;
    ``backend`` defaults by device (``default_backend``).  ``fn`` and its
    return value are pickled: ``fn`` must be importable from the port, and
    a return value should hold host arrays.  A rank that raises, dies or
    outlasts ``timeout`` seconds fails the call, and every rank still
    running is stopped."""
    if world < 1:
        raise ValueError(f"need world >= 1, got {world}")
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        devices = list(devices) if devices is not None else \
            [f"cuda:{r}" for r in range(world)]
    else:
        devices = ["cpu"] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    values: dict = {}
    with tempfile.TemporaryDirectory(prefix="tpums-ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                             args=(r, world, init, backend, devices[r], fn,
                                   tuple(args), dict(kwargs or {}),
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(values) < world:
                try:
                    r, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [p for p in procs
                            if p.exitcode is not None and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(
                            f"{dead[0].name} exited with code "
                            f"{dead[0].exitcode} before it reported")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world - len(values)} of {world} ranks did "
                            f"not finish within {timeout:.0f}s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {world} failed:\n"
                                       f"{value}")
                values[r] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 5.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [values[r] for r in range(world)]
