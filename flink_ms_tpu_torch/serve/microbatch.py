"""Cross-request top-k batching: concurrent TOPK/TOPKV requests share one
device dispatch.

Counterpart of ``flink_ms_tpu/serve/microbatch.py``, copied: it is host
threading over ``DeviceFactorIndex.topk_many``.  Requests enqueue into a
coalescing queue; ONE dispatcher thread drains up to ``max_batch`` waiting
queries (after at most a ``max_wait_us`` coalescing window), scores them
with a single batched matrix product and top-k, and hands each parked
handler thread its own rows.  Unbatched, B concurrent requests serialize
on the index lock and read the whole catalog B times; batched, the
catalog is read once per dispatch.

Knobs, read once per batcher at construction:

- ``TPUMS_TOPK_BATCH``          "1" (default) enable, "0" disable
- ``TPUMS_TOPK_BATCH_MAX``      max queries per device dispatch (default 32)
- ``TPUMS_TOPK_BATCH_WAIT_US``  coalescing window in microseconds
                                (default 200): the most a lone request
                                waits for the chance to share a dispatch.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics


def batching_enabled() -> bool:
    return os.environ.get("TPUMS_TOPK_BATCH", "1") != "0"


class PendingTopK:
    """One enqueued query: the submitting thread parks on ``wait()`` while
    the dispatcher scores the coalesced batch and hands back the result
    (or its group's error).

    Span fields, filled in by the dispatcher: ``queue_wait_s`` (enqueue to
    dispatch), ``batch_size`` (queries sharing the dispatch), ``device_s``
    (the group's scoring time, results on the host)."""

    __slots__ = ("vec", "k", "result", "error", "_event",
                 "t_enqueue", "queue_wait_s", "batch_size", "device_s")

    def __init__(self, vec: np.ndarray, k: int):
        self.vec = vec
        self.k = k
        self.result: Optional[List[Tuple[str, float]]] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self.t_enqueue = time.perf_counter()
        self.queue_wait_s: Optional[float] = None
        self.batch_size: Optional[int] = None
        self.device_s: Optional[float] = None

    def _finish(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("batched top-k still queued at deadline")
        if self.error is not None:
            raise self.error
        return self.result


class TopKBatcher:
    """Coalesces concurrent top-k queries into shared device dispatches.

    ``submit(vec, k)`` does not block (it returns a :class:`PendingTopK`);
    ``score(vec, k)`` submits and waits.  The dispatcher thread starts on
    the first submit and groups drained queries by ``(k, vector shape)``,
    so a mix of k values or widths becomes several smaller dispatches and
    a bad group fails only its own queries.

    Idle fast path: once the dispatcher exists, a submit that finds the
    batcher idle (empty queue, nothing executing) scores inline in the
    caller's thread through the single-query path, adding no latency at
    concurrency 1.

    Counters (test hooks): ``submitted``, ``dispatches``,
    ``batched_queries``, ``max_batch_seen``, ``inline_singles``;
    ``dispatches < submitted`` shows coalescing happened."""

    def __init__(self, index, max_batch: Optional[int] = None,
                 max_wait_us: Optional[float] = None):
        self.index = index
        self.max_batch = int(
            os.environ.get("TPUMS_TOPK_BATCH_MAX", 32)
            if max_batch is None else max_batch
        )
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_s = float(
            os.environ.get("TPUMS_TOPK_BATCH_WAIT_US", 200)
            if max_wait_us is None else max_wait_us
        ) / 1e6
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._flush = False
        self._executing = 0  # in-flight scorings: dispatcher + inline
        self.submitted = 0
        self.dispatches = 0
        self.batched_queries = 0
        self.max_batch_seen = 0
        self.inline_singles = 0
        reg = obs_metrics.get_registry()
        self._obs_queue_wait = reg.histogram("tpums_topk_queue_wait_seconds")
        self._obs_batch_size = reg.histogram(
            "tpums_topk_batch_size", bounds=obs_metrics.SIZE_BUCKETS)
        self._obs_device = reg.histogram("tpums_topk_device_seconds")

    # -- submit side --------------------------------------------------------

    def submit(self, vec: np.ndarray, k: int,
               allow_inline: bool = True) -> PendingTopK:
        """``allow_inline=False`` enqueues even when idle: a server passes
        it for every member of a pipelined burst, whose next submit is
        already in hand."""
        pending = PendingTopK(np.asarray(vec, dtype=np.float32), int(k))
        inline = False
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="topk-batcher", daemon=True
                )
                self._thread.start()
            elif allow_inline and not self._queue and self._executing == 0:
                # idle: nothing to coalesce WITH, so the window could only
                # add latency; score in the caller's thread
                inline = True
                self._executing += 1
            self.submitted += 1
            if not inline:
                self._queue.append(pending)
                self._cond.notify_all()
        if inline:
            try:
                self.inline_singles += 1
                t0 = time.perf_counter()
                result = self.index.topk(pending.vec, pending.k)
                pending.queue_wait_s = 0.0
                pending.batch_size = 1
                pending.device_s = time.perf_counter() - t0
                # no registry observation: an inline single's queue wait is
                # 0 and its device time is the verb latency the server
                # already records
                pending._finish(result=result)
            except BaseException as e:
                pending._finish(error=e)
            finally:
                with self._cond:
                    self._executing -= 1
        return pending

    def score(self, vec: np.ndarray, k: int,
              timeout: Optional[float] = None):
        return self.submit(vec, k).wait(timeout)

    def flush(self) -> None:
        """The submitting burst is complete: dispatch what is queued now
        instead of holding the coalescing window open."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()

    def close(self) -> None:
        """Stop the dispatcher, after it drains the queue so no submitter
        is left parked.  Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- dispatcher ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # coalescing window: give concurrent arrivals max_wait_s
                # to share this dispatch, but never hold a full batch
                if (len(self._queue) < self.max_batch
                        and self.max_wait_s > 0 and not self._flush):
                    deadline = time.monotonic() + self.max_wait_s
                    while (len(self._queue) < self.max_batch
                           and not self._closed and not self._flush):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                self._flush = False
                batch = [
                    self._queue.popleft()
                    for _ in range(min(len(self._queue), self.max_batch))
                ]
                # arrivals during the dispatch must enqueue (to coalesce
                # into the NEXT batch), not take the idle fast path
                self._executing += 1
            try:
                self._dispatch(batch)
            except BaseException as e:  # the loop must survive anything:
                # a dead dispatcher would park every future submitter
                for p in batch:
                    if not p._event.is_set():
                        p._finish(error=e)
            finally:
                with self._cond:
                    self._executing -= 1

    def _dispatch(self, batch: List[PendingTopK]) -> None:
        groups: dict = {}
        for p in batch:
            groups.setdefault((p.k, p.vec.shape), []).append(p)
        for (k, _shape), group in groups.items():
            t_disp = time.perf_counter()
            try:
                if len(group) == 1 and not getattr(
                    self.index, "prefers_frames", False
                ):
                    # a lone query takes the single-query path, as the
                    # unbatched handler does; an IVF index prefers frames
                    results = [self.index.topk(group[0].vec, k)]
                else:
                    results = self.index.topk_many(
                        np.stack([p.vec for p in group]), k
                    )
            except Exception as e:
                # a bad group (e.g. width mismatch vs the index) fails its
                # own members; other groups in the batch still score
                for p in group:
                    p._finish(error=e)
                continue
            # the index's results reach the host through its _to_host,
            # which waits for the device: this is the device's time, not
            # the launch's
            device_s = time.perf_counter() - t_disp
            self.dispatches += 1
            self.batched_queries += len(group)
            if len(group) > self.max_batch_seen:
                self.max_batch_seen = len(group)
            metrics_on = obs_metrics.metrics_enabled()
            if metrics_on:
                self._obs_batch_size.observe(len(group))
                self._obs_device.observe(device_s)
            for p, result in zip(group, results):
                p.queue_wait_s = t_disp - p.t_enqueue
                p.batch_size = len(group)
                p.device_s = device_s
                if metrics_on:
                    self._obs_queue_wait.observe(p.queue_wait_s)
                p._finish(result=result)
