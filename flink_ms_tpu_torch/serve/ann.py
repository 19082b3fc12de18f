"""IVF approximate-nearest-neighbour tier of the top-k index.

Counterpart of ``flink_ms_tpu/serve/ann.py``: the classic inverted-file
recipe for maximum-inner-product retrieval over ALS item factors, its four
jitted programs written as torch operations on the index's device.

- **Build** (on the rebuild thread, off the query path): a coarse k-means
  quantizer trained by Lloyd's iterations over a bounded training sample
  (an ``argmin`` of ``|c|^2 - 2 x.c`` and ``index_add_`` sums per chunk),
  then ONE chunked assignment pass over the whole catalog.  Rows land in
  fixed-capacity posting lists, an (nlist, list_len) int32 array padded
  with -1; rows past a list's capacity are dropped from the tier (counted
  in ``dropped``, and seen by the recall probe).
- **Query**: score the query against the centroids by inner product (the
  retrieval metric), take the ``nprobe`` best lists, gather their rows
  FROM THE RESIDENT FACTOR MATRIX, and re-rank the shortlist exactly.  The
  only approximation is a missing candidate; returned scores are exact.
- **Contract**: the build measures recall@k against the exact scan on
  catalog rows used as queries (``recall_probe``); the index gates on it
  (``TPUMS_ANN_RECALL_MIN``, ``topk.py``).

Knobs, as in the reference: ``TPUMS_ANN_NLIST``, ``TPUMS_ANN_NPROBE``,
``TPUMS_ANN_LIST_ALPHA`` (list capacity over the mean occupancy, default 2),
``TPUMS_ANN_KMEANS_ITERS``, ``TPUMS_ANN_TRAIN_CAP``,
``TPUMS_ANN_PROBE_QUERIES``, ``TPUMS_ANN_PROBE_K``.  The training sample,
the initial centroids and the probe's queries come from one
``np.random.default_rng(seed)`` stream drawn in the reference's order, so
both packages start from the same centroids.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .topk import topk_lowest_first

# rows per assignment step: the (chunk, nlist) f32 distance matrix a step
# materializes is 32k x 4096 = 512 MB at the 10M-row catalog's sizing, a
# bound an unchunked O(n * nlist) pass would not have
_ASSIGN_CHUNK = 1 << 15
# score stamped on masked shortlist slots so they never win a top-k over a
# real row; far below any realistic factor dot product
_PAD_SCORE = -1e30
# recall-probe queries scored per exact scan: (16, n) f32 scores and their
# keys, 1.3 GB at 10M rows
_PROBE_CHUNK = 16


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _assign(x: torch.Tensor, cent: torch.Tensor,
            cent_sq: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row of ``x`` in L2:
    argmin |x - c|^2 == argmin (|c|^2 - 2 x.c), the first on ties."""
    return torch.argmin(cent_sq[None, :] - 2.0 * (x @ cent.T), dim=1)


def _search(cent, postings, matrix, q, k: int, nprobe: int):
    """Probe, gather and exact re-rank of a (B, d) query frame ->
    (scores (B, k), row indices (B, k), -1 in empty shortlist slots)."""
    _, probe = topk_lowest_first(q @ cent.T, nprobe)   # retrieval metric
    cand = postings[probe].reshape(q.shape[0], -1)      # (B, C)
    valid = cand >= 0
    vecs = matrix[torch.where(valid, cand, 0).long()]   # (B, C, d)
    scores = torch.bmm(vecs, q[:, :, None])[..., 0]
    scores = torch.where(valid, scores, _PAD_SCORE)
    s, i = topk_lowest_first(scores, k)
    idx = cand.gather(1, i)
    # a slot still at the pad floor is an empty shortlist slot, not a row
    return s, torch.where(s > _PAD_SCORE * 0.5, idx, -1)


class IVFIndex:
    """Built coarse quantizer + posting lists + measured recall probe.

    Immutable after ``build``: the owning index builds a fresh one at every
    full rebuild, so updates to EXISTING rows need no IVF maintenance (the
    lists hold row indices and the re-rank reads current values from the
    live matrix)."""

    def __init__(self, centroids, postings, nlist: int, nprobe: int,
                 list_len: int, recall_probe: float, n_rows: int,
                 dropped: int, probe_k: int):
        self.centroids = centroids      # (nlist, d) on the device
        self.postings = postings        # (nlist, list_len) int32
        self.nlist = nlist
        self.nprobe = nprobe
        self.list_len = list_len
        self.recall_probe = recall_probe
        self.n_rows = n_rows
        self.dropped = dropped          # overflow rows absent from lists
        self.probe_k = probe_k

    # -- building -----------------------------------------------------------

    @classmethod
    def default_nlist(cls, n: int) -> int:
        want = _env_int("TPUMS_ANN_NLIST", 0)
        if want > 0:
            return min(want, max(n, 1))
        return max(8, min(4096, _pow2(int(4.0 * np.sqrt(max(n, 1))))))

    @classmethod
    def default_nprobe(cls, nlist: int) -> int:
        want = _env_int("TPUMS_ANN_NPROBE", 0)
        if want > 0:
            return min(want, nlist)
        return max(4, nlist // 16)

    @classmethod
    def build(cls, rows, nlist: Optional[int] = None,
              nprobe: Optional[int] = None, seed: int = 0,
              device="cuda") -> "IVFIndex":
        """Build over ``rows`` (n, d) float32: a numpy array, uploaded to
        ``device``, or a tensor, used where it lies (the top-k index passes
        its resident matrix, so the catalog is not copied twice)."""
        if isinstance(rows, torch.Tensor):
            x = rows.float().contiguous()
        else:
            x = torch.from_numpy(
                np.ascontiguousarray(rows, dtype=np.float32)).to(
                    resolve_device(device))
        dev = x.device
        n, d = x.shape
        nlist = nlist or cls.default_nlist(n)
        nprobe = nprobe or cls.default_nprobe(nlist)
        rng = np.random.default_rng(seed)

        # -- train the quantizer on a bounded sample (~64 points per
        # centroid, capped: the recall probe is the arbiter) --
        iters = _env_int("TPUMS_ANN_KMEANS_ITERS", 6)
        sample_cap = min(
            n, 64 * nlist, _env_int("TPUMS_ANN_TRAIN_CAP", 1 << 17))
        train = (
            x if sample_cap >= n
            else x[torch.from_numpy(
                rng.choice(n, size=sample_cap, replace=False)).to(dev)]
        )
        cent = train[torch.from_numpy(
            rng.choice(train.shape[0], size=nlist, replace=False)).to(dev)]
        ones = torch.ones(min(_ASSIGN_CHUNK, train.shape[0]), device=dev)
        for _ in range(max(iters, 1)):
            cent_sq = (cent * cent).sum(dim=1)
            sums = torch.zeros_like(cent)
            counts = torch.zeros(nlist, device=dev)
            for lo in range(0, train.shape[0], _ASSIGN_CHUNK):
                block = train[lo:lo + _ASSIGN_CHUNK]
                a = _assign(block, cent, cent_sq)
                sums.index_add_(0, a, block)
                counts.index_add_(0, a, ones[:block.shape[0]])
            # empty clusters keep their old centroid (re-seeding would make
            # the refresh non-deterministic for no measured recall gain)
            cent = torch.where(counts[:, None] > 0,
                               sums / counts.clamp(min=1.0)[:, None], cent)

        # -- one full-catalog assignment pass --
        cent_sq = (cent * cent).sum(dim=1)
        assign = torch.empty(n, dtype=torch.int32, device=dev)
        for lo in range(0, n, _ASSIGN_CHUNK):
            assign[lo:lo + _ASSIGN_CHUNK] = _assign(
                x[lo:lo + _ASSIGN_CHUNK], cent, cent_sq)
        assign = assign.cpu().numpy()

        # -- fixed-capacity posting lists: (nlist, L) row indices,
        # -1-padded, overflowing rows dropped --
        alpha = float(os.environ.get("TPUMS_ANN_LIST_ALPHA", 2.0))
        list_len = max(1, int(np.ceil(alpha * n / nlist)))
        counts = np.bincount(assign, minlength=nlist)
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        rank = np.arange(n) - starts[sorted_assign]
        keep = rank < list_len
        postings_np = np.full((nlist, list_len), -1, np.int32)
        postings_np[sorted_assign[keep], rank[keep]] = order[keep]
        postings = torch.from_numpy(postings_np).to(dev)
        dropped = int(n - keep.sum())

        idx = cls(
            centroids=cent, postings=postings, nlist=nlist, nprobe=nprobe,
            list_len=list_len, recall_probe=0.0, n_rows=n, dropped=dropped,
            probe_k=0,
        )
        idx._measure_recall(x, rng)
        return idx

    def _measure_recall(self, rows: torch.Tensor, rng) -> None:
        """recall@k of the probe path against the exact scan, on catalog
        rows used as queries (items recommend their own neighbourhood: the
        hardest realistic query distribution for IVF)."""
        n = self.n_rows
        nq = min(_env_int("TPUMS_ANN_PROBE_QUERIES", 64), n)
        k = min(_env_int("TPUMS_ANN_PROBE_K", 100), n,
                self.nprobe * self.list_len)
        q = rows[torch.from_numpy(
            rng.choice(n, size=nq, replace=False)).to(rows.device)]
        exact = np.concatenate([
            topk_lowest_first(q[lo:lo + _PROBE_CHUNK] @ rows.T, k)[1].cpu()
            for lo in range(0, nq, _PROBE_CHUNK)
        ])
        got = self.search(rows, q, k)[1].cpu().numpy()
        hits = 0
        for r in range(nq):
            hits += len(np.intersect1d(exact[r], got[r][got[r] >= 0]))
        self.recall_probe = hits / float(nq * k)
        self.probe_k = k

    # -- querying -----------------------------------------------------------

    def search(self, matrix: torch.Tensor, q: torch.Tensor, k: int):
        """(B, d) query frame -> (scores, idx) tensors on the device.
        ``matrix`` is the resident factor matrix; the returned width is
        ``min(k, nprobe * list_len)`` and empty shortlist slots carry
        ``idx == -1``."""
        k_eff = min(k, self.nprobe * self.list_len)
        return _search(self.centroids, self.postings, matrix, q, k_eff,
                       self.nprobe)
