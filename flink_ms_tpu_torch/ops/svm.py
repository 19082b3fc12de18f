"""CoCoA distributed linear SVM on CUDA cards, its chains split over ranks.

Counterpart of ``flink_ms_tpu/ops/svm.py`` (the capability behind
``SVM().fit(trainingDS)``, ``flink-svm/.../SVMImpl.scala:24-29``; FlinkML's
CoCoA + local SDCA [dep]):

    min_w  (λ/2)||w||² + (1/n) Σ_j max(0, 1 − y_j w·x_j)

The examples are split into K logical blocks (``setBlocks``), each an
independent SDCA chain.  Over D ranks (``parallel/distributed.py``, one
process per GPU) the K chains are padded with empty ones to Kp, a
multiple of D, and rank d runs chains [d·C, (d+1)·C), C = Kp/D; outside a
process group D = 1 and C = K.  Every step advances a rank's C chains at
once.  Each round, each chain runs H closed-form hinge dual steps against
its own view of w, and the chains' updates are combined once, by one
``all_reduce`` of Δw over the ranks (the reference's ``psum``): averaged
(``mode="avg"``, CoCoA-v1, σ′ = 1) or added (``mode="add"``, CoCoA+, with
the local subproblem smoothed by σ′, the safe γ·K by default); the
combination scale uses the real K.  The host layout is the reference's,
copied as numpy and equal to it array for array.

Two inner engines, the same update sequence with reassociated arithmetic:

- ``scatter``: each step gathers and scatters a (C, d) chain-local copy of
  w (plain torch, no kernel);
- ``gram``: each chain's (H, H) row-Gram matrix is built once per fit, a
  running margin vector absorbs every update through one Gram row, and w
  is touched twice a round, by the two CUDA kernels of
  ``ops/svm_kernels.py``: ``margin_gather`` for the round-start margins
  and ``scatter_add_dw`` for Δw = XᵀΔα.  On CPU tensors they run their
  plain versions.

``auto`` takes the gram engine when the (C, H, H) tensor fits
``FLINK_MS_SVM_GRAM_BYTES`` (default 1 GiB), as the reference does.

Step indices: the reference draws them with threefry inside the loop,
which torch cannot reproduce.  The port draws each round's (K, H) table of
row indices from a ``torch.Generator`` on the host seeded from (seed,
absolute round), and each rank keeps its chains' rows, so a fit continued
with ``start=`` equals one long fit, and the model depends neither on the
device nor on D (as the reference's global chain ids make its draws).
``fit`` also takes the table injected (``steps=``, sliced the same way),
which is how the tests run the reference's own draws through the port.

The gram engine's opt-in modes, read when a fit is compiled, as in the
reference:

- ``FLINK_MS_SVM_STEP=auto|dynamic|onehot``: one path here, the dynamic
  step.  The reference's one-hot step writes every read and write of
  chain state as a dense one-hot contraction, a layout for the TPU's
  matrix unit; its products are exact 0s and 1s, so it gives the dynamic
  step's bits, and on the card it was only slower;
- ``FLINK_MS_SVM_DW=auto|direct|sorted|presorted|pallas``: auto, direct
  and pallas are the scatter-add kernel; sorted and presorted make Δw a
  sorted segment sum (plain torch, no kernel) over a feature-sorted layout
  built on the device at compile time, whose values are stored already
  sorted so a round gathers only Δα.  The reference's ``sorted`` gathers
  the round's whole contribution through the sort permutation instead;
  it forms the same products, so here it is the presorted layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.formats import SparseData
from ..parallel import distributed as pdist
from ..parallel.mesh import local_device, num_blocks
from .svm_kernels import margin_gather, scatter_add_dw


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    iterations: int = 10          # outer CoCoA rounds (SVMImpl --iteration)
    local_iterations: int = 10    # SDCA steps per block per round [dep default]
    regularization: float = 1.0   # λ [dep default]
    stepsize: float = 1.0         # β (avg) / γ (add) scaling of the update
    seed: int = 0
    mode: str = "avg"             # "avg" = CoCoA-v1 parity, "add" = CoCoA+
    # local-subproblem smoothing σ' for mode="add" (CoCoA+).  None = the
    # provably safe γ·K.  Values in [1, γK) are the aggressive regime for
    # sparse data whose blocks' updates rarely collide.  Ignored in avg mode.
    sigma_prime: Optional[float] = None
    dtype: torch.dtype = torch.float32
    # inner engine: "scatter" | "gram" | "auto" (gram when the (C, H, H)
    # Gram tensor fits FLINK_MS_SVM_GRAM_BYTES, default 1 GiB)
    inner: str = "auto"

    def __post_init__(self):
        if self.mode not in ("avg", "add"):
            raise ValueError("mode must be avg or add")
        if self.sigma_prime is not None and self.sigma_prime < 1.0:
            raise ValueError("sigma_prime must be >= 1")
        if self.inner not in ("auto", "gram", "scatter"):
            raise ValueError("inner must be auto|gram|scatter")


@dataclasses.dataclass
class SVMModel:
    weights: np.ndarray  # (n_features,) dense primal vector

    def decision_function(self, data: SparseData) -> np.ndarray:
        if data.n_examples == 0:
            return np.zeros(0)
        contrib = data.values * self.weights[data.indices]
        # reduceat over CSR row starts; empty rows need explicit zeroing
        # (reduceat on an empty segment returns the next element)
        sums = np.zeros(data.n_examples)
        starts = data.indptr[:-1]
        nonempty = data.indptr[1:] > starts
        if contrib.size:
            red = np.add.reduceat(contrib, np.minimum(starts, contrib.size - 1))
            sums[nonempty] = red[nonempty]
        return sums

    def hinge_loss(self, data: SparseData, lambda_: float) -> float:
        margins = data.labels * self.decision_function(data)
        return float(
            np.mean(np.maximum(0.0, 1.0 - margins))
            + 0.5 * lambda_ * float(self.weights @ self.weights)
        )


# ---------------------------------------------------------------------------
# host-side layout (copied from the reference, numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockedSVMProblem:
    """Examples split into K logical blocks with per-row padded sparse
    storage (K = the reference's ``setBlocks``).

    Padding rows have label 0 and empty features; the SDCA step masks them
    (zero row norm => zero update), so they never affect the solution.
    """

    n_blocks: int
    n_examples: int      # real examples (pre-padding)
    n_features: int
    rows_per_block: int
    idx: np.ndarray      # (K, rows_pb, L) int32 feature indices (0-based)
    val: np.ndarray      # (K, rows_pb, L) values, 0 where padded
    label: np.ndarray    # (K, rows_pb) +-1, 0 for padding rows
    sq_norm: np.ndarray  # (K, rows_pb) ||x_j||^2


def prepare_svm_blocked(
    data: SparseData, n_blocks: int, seed: int = 0, dtype=np.float32
) -> BlockedSVMProblem:
    """Vectorized re-layout: shuffle examples across K blocks, pad each row
    to the max nnz."""
    n = data.n_examples
    rows_pb = -(-n // n_blocks) if n else 1
    lens = (data.indptr[1:] - data.indptr[:-1]).astype(np.int64)
    L = max(int(lens.max()) if n else 1, 1)

    # padded row-major staging in original example order
    mask = np.arange(L)[None, :] < lens[:, None]           # (n, L)
    idx_rows = np.zeros((n, L), dtype=np.int32)
    val_rows = np.zeros((n, L), dtype=dtype)
    idx_rows[mask] = data.indices                          # CSR order
    val_rows[mask] = data.values.astype(dtype)

    order = np.random.default_rng(seed).permutation(n)     # slot s <- example
    idx = np.zeros((n_blocks * rows_pb, L), dtype=np.int32)
    val = np.zeros((n_blocks * rows_pb, L), dtype=dtype)
    label = np.zeros((n_blocks * rows_pb,), dtype=dtype)
    idx[:n] = idx_rows[order]
    val[:n] = val_rows[order]
    signs = np.sign(data.labels[order]).astype(dtype)
    label[:n] = np.where(signs == 0, 1.0, signs)           # labels must be +-1
    sq_norm = np.sum(val.astype(np.float64) ** 2, axis=-1).astype(dtype)
    # slot s -> (block s // rows_pb, row s % rows_pb): contiguous rows per
    # block, matching the reference's partition-then-iterate layout
    return BlockedSVMProblem(
        n_blocks=n_blocks,
        n_examples=n,
        n_features=data.n_features,
        rows_per_block=rows_pb,
        idx=idx.reshape(n_blocks, rows_pb, L),
        val=val.reshape(n_blocks, rows_pb, L),
        label=label.reshape(n_blocks, rows_pb),
        sq_norm=sq_norm.reshape(n_blocks, rows_pb),
    )


def _step_choice() -> str:
    """FLINK_MS_SVM_STEP: auto, dynamic and onehot all run the dynamic
    step (see the module docstring); any other value raises rather than
    run another path."""
    choice = os.environ.get("FLINK_MS_SVM_STEP", "auto")
    if choice not in ("auto", "dynamic", "onehot"):
        raise ValueError(
            f"FLINK_MS_SVM_STEP={choice!r} must be auto|dynamic|onehot")
    return "dynamic"


def _dw_choice() -> str:
    """FLINK_MS_SVM_DW -> "direct" | "sorted".  auto, direct and pallas
    are the reference's direct scatter and its Pallas kernel, one path
    here, the scatter-add kernel; sorted and presorted are the sorted
    segment sum over the presorted layout; a typo raises."""
    choice = os.environ.get("FLINK_MS_SVM_DW", "auto")
    if choice not in ("auto", "direct", "sorted", "presorted", "pallas"):
        raise ValueError(
            f"FLINK_MS_SVM_DW={choice!r} must be "
            "auto|direct|sorted|presorted|pallas")
    return "sorted" if choice in ("sorted", "presorted") else "direct"


def sorted_layout(idx: torch.Tensor, val: torch.Tensor, d: int):
    """The feature-sorted layout of the flattened (C, H, L) entries that
    the sorted Δw modes read (the reference's presorted layout,
    ``flink_ms_tpu/ops/svm.py`` ``compile_svm_fit``), built where ``idx``
    lies: a stable sort of the ids, the values in sorted order, the flat
    (C·H) row of each, and the (d,) segment lengths of the sorted ids.
    -> [val_s, src, lengths]."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    lengths = torch.bincount(flat.long(), minlength=d)
    return [val.reshape(-1)[order], order // idx.shape[-1], lengths]


def _rank_chains(K: int):
    """-> (C, lo): this rank runs the C = round_up(K, D)/D global chains
    [lo, lo + C); those past K are empty pads."""
    C = -(-K // num_blocks())
    return C, pdist.rank() * C


def _resolve_inner(problem: BlockedSVMProblem, config: SVMConfig) -> str:
    """auto -> gram|scatter, from the per-rank (C, H, H) Gram budget
    (FLINK_MS_SVM_GRAM_BYTES, default 1 GiB)."""
    if config.inner != "auto":
        return config.inner
    C = _rank_chains(problem.n_blocks)[0]
    H = problem.rows_per_block
    gram_bytes = C * H * H * torch.finfo(config.dtype).bits // 8
    limit = int(os.environ.get("FLINK_MS_SVM_GRAM_BYTES", 1 << 30))
    return "gram" if gram_bytes <= limit else "scatter"


def draw_steps(seed: int, round_: int, chains: int, rows: int,
               steps: int) -> torch.Tensor:
    """-> (chains, steps) int64 row indices in [0, rows) for one round,
    drawn on the host from a generator seeded by (seed, absolute round),
    hashed into the 32 bits that torch's CPU generator (mt19937) keeps of
    a seed."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                 int(round_) & 0xFFFFFFFF])
    state = ss.generate_state(1, np.uint32)
    gen = torch.Generator().manual_seed(int(state[0]))
    return torch.randint(0, rows, (chains, steps), generator=gen)


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def build_gram(idx: torch.Tensor, val: torch.Tensor, d: int,
               dtype=torch.float32) -> torch.Tensor:
    """Per-chain row-Gram G[c] = S_c S_cᵀ (C, H, H) by densify and one
    batched product: the chains' padded sparse rows are added into an
    (B, H, d) dense buffer (duplicate ids accumulate), and ``torch.bmm``
    takes the (H, H) products in full f32.  B bounds the buffer to
    256 MiB, the reference's chunk budget.  Pad slots have val 0 and add
    nothing."""
    C, H, L = idx.shape
    itemsize = torch.finfo(dtype).bits // 8
    B = max(int((256 << 20) // max(H * d * itemsize, 1)), 1)
    out = torch.empty((C, H, H), dtype=dtype, device=idx.device)
    rows = torch.arange(H, device=idx.device)[None, :, None]
    for s in range(0, C, B):
        e = min(s + B, C)
        dense = torch.zeros((e - s, H, d), dtype=dtype, device=idx.device)
        chains = torch.arange(e - s, device=idx.device)[:, None, None]
        dense.index_put_(
            (chains.expand(-1, H, L), rows.expand(e - s, -1, L),
             idx[s:e].long()),
            val[s:e].to(dtype), accumulate=True)
        torch.bmm(dense, dense.transpose(1, 2), out=out[s:e])
    return out


def _make_fit(problem: BlockedSVMProblem, config: SVMConfig,
              dev: torch.device):
    K = problem.n_blocks               # real logical blocks
    C, lo = _rank_chains(K)            # this rank's chains [lo, lo + C)
    n = problem.n_examples
    lam = config.regularization
    H = config.local_iterations
    lam_n = lam * max(n, 1)
    if config.mode == "avg":
        gamma = config.stepsize / K    # averaged combination (CoCoA-v1)
        sigma_p = 1.0
    else:
        gamma = config.stepsize        # added combination (CoCoA+)
        sigma_p = (                    # safe default σ' = γK
            config.sigma_prime if config.sigma_prime is not None
            else config.stepsize * K
        )
    rows_pb = problem.rows_per_block
    d = problem.n_features
    inner = _resolve_inner(problem, config)
    _step_choice()
    dw_mode = _dw_choice() if inner == "gram" else "direct"
    chains = torch.arange(C, device=dev)
    grouped = pdist.in_group()

    def rank_rows(table):
        """This rank's C rows of a (K, ...) per-chain table; empty pad
        chains past K get zeros (their steps change nothing)."""
        out = table[lo:lo + C]
        if out.shape[0] < C:
            out = torch.cat([out, out.new_zeros((C - out.shape[0],
                                                 *out.shape[1:]))])
        return out

    def dual_step(a_j, y, wx_j, qii):
        """The closed-form hinge dual step on the σ'-smoothed local
        subproblem, clipped to the box [0, 1]; -> Δα_j (0 on pad rows)."""
        grad = 1.0 - y * wx_j
        new_dual = torch.clamp(
            a_j * y + grad * lam_n / (sigma_p * torch.clamp_min(qii, 1e-12)),
            0.0, 1.0,
        )
        return torch.where(qii > 0, y * new_dual - a_j, 0.0)

    def scatter_round(w, idx, val, label, sq_norm, alpha, j_all):
        """H serial SDCA steps of every chain against a (C, d) chain-local
        copy of w; each step is a (C, L) gather and scatter-add."""
        w_loc = w.expand(C, d).clone()
        a = alpha.clone()
        for h in range(H):
            j = j_all[:, h]
            ids = idx[chains, j].long()
            x = val[chains, j]
            y = label[chains, j]
            qii = sq_norm[chains, j]
            wx = (torch.gather(w_loc, 1, ids) * x).sum(-1)
            a_j = a[chains, j]
            delta = dual_step(a_j, y, wx, qii)
            a[chains, j] = a_j + delta
            # the chain-local view carries σ' (σ' = 1 in avg mode)
            w_loc.scatter_add_(1, ids, (sigma_p * delta)[:, None] * x / lam_n)
        # Δw of each chain under the TRUE coupling: (w_loc − w)/σ', summed
        # over the rank's chains, then over the ranks
        dw = ((w_loc - w) / sigma_p).sum(0)
        if grouped:
            pdist.all_reduce_sum(dw)
        return w + gamma * dw, alpha + gamma * (a - alpha)

    def dynamic_steps(wx, label, sq_norm, alpha, gram, j_all):
        """H serial SDCA steps of every chain on a running (C, rows) margin
        vector: each update enters through one Gram row.  -> Δα."""
        y_all = torch.gather(label, 1, j_all)
        q_all = torch.gather(sq_norm, 1, j_all)
        a = alpha.clone()
        for h in range(H):
            j = j_all[:, h]
            a_j = a[chains, j]
            delta = dual_step(a_j, y_all[:, h], wx[chains, j], q_all[:, h])
            a[chains, j] = a_j + delta
            wx = wx + (sigma_p * delta / lam_n)[:, None] * gram[chains, j]
        return a - alpha

    def gram_round(w, idx, val, label, sq_norm, alpha, gram, j_all, *dw_args):
        """One round of the gram engine: w is read once (``margin_gather``)
        and written once, by ``scatter_add_dw`` with Δα as its row scale
        (direct), or by a sorted segment sum over ``sorted_layout``'s
        arrays (sorted)."""
        wx = margin_gather(w, idx, val)
        dalpha = dynamic_steps(wx, label, sq_norm, alpha, gram, j_all)
        if dw_mode == "direct":
            dw = scatter_add_dw(idx, val, d, row_scale=dalpha)
        else:
            val_s, src, lengths = dw_args
            contrib = val_s * torch.index_select(dalpha.reshape(-1), 0, src)
            dw = torch.segment_reduce(contrib, "sum", lengths=lengths)
        if grouped:
            pdist.all_reduce_sum(dw)
        return w + gamma * (dw / lam_n), alpha + gamma * dalpha

    def fit(rounds, w, idx, val, label, sq_norm, alpha, seed, gram=None,
            *dw_args, start=0, steps=None):
        """Rounds [start, start + rounds) from (w, alpha) -> (w, alpha).
        ``fit(rounds, *dev_args)`` runs from scratch; ``start=r0`` with the
        w and alpha of a previous call continues it exactly, because each
        round's step table depends on its absolute index.  ``steps``, when
        given, is the (rounds, K, H) table of row indices of every chain to
        use instead; each rank keeps its chains' rows.
        ``dw_args``: the sorted modes' layout (``sorted_layout``)."""
        rounds = int(rounds)
        if steps is not None:
            if not isinstance(steps, torch.Tensor):
                steps = torch.from_numpy(np.array(steps, dtype=np.int64))
            steps = steps.to(dev, torch.int64)
            if tuple(steps.shape) != (rounds, K, H):
                raise ValueError(f"steps must be ({rounds}, {K}, {H}), got "
                                 f"{tuple(steps.shape)}")
            if steps.numel() and not bool(
                    ((steps >= 0) & (steps < rows_pb)).all()):
                raise ValueError(f"steps must lie in [0, {rows_pb})")
        if inner == "gram" and gram is None:
            raise ValueError("the gram engine needs the Gram tensor as its "
                             "last device argument (compile_svm_fit)")
        for r in range(start, start + rounds):
            if steps is not None:
                j_all = rank_rows(steps[r - start])
            else:
                # the whole table, so D does not change a chain's draws
                j_all = rank_rows(draw_steps(seed, r, K, rows_pb, H))
                if dev.type == "cuda":
                    # pinned and asynchronous: the host draws the next
                    # round's table while the card runs this one
                    j_all = j_all.pin_memory().to(dev, non_blocking=True)
            if inner == "gram":
                w, alpha = gram_round(w, idx, val, label, sq_norm, alpha,
                                      gram, j_all, *dw_args)
            else:
                w, alpha = scatter_round(w, idx, val, label, sq_norm, alpha,
                                         j_all)
        return w, alpha

    return fit, inner, dw_mode


def compile_svm_fit(problem: BlockedSVMProblem, config: SVMConfig,
                    device="cuda"):
    """-> (fit_fn, dev_args): the CoCoA fit plus this rank's
    device-resident inputs [w0, idx, val, label, sq_norm, alpha0, seed] (its
    C chains, pad chains past K empty) and, on the gram engine, their Gram
    tensor built here once, followed in a sorted Δw mode by the arrays of
    ``sorted_layout``, also built here once.  ``fit_fn(rounds, *dev_args)``
    -> (w, the rank's alpha) device tensors, leaving ``dev_args`` as they
    were; w is the same on every rank.  Benchmarks call ``fit_fn``
    directly so host-to-device copies and the Gram build stay out of the
    timed region."""
    dev = local_device(device)
    dtype = config.dtype
    fit, inner, dw_mode = _make_fit(problem, config, dev)
    C, lo = _rank_chains(problem.n_blocks)

    def put(a, dt):
        # this rank's chains, padded with empty ones past K
        a = a[lo:lo + C]
        if a.shape[0] < C:
            a = np.concatenate([a, np.zeros((C - a.shape[0], *a.shape[1:]),
                                            a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    dev_args = [
        torch.zeros(problem.n_features, dtype=dtype, device=dev),
        put(problem.idx, torch.int32),
        put(problem.val, dtype),
        put(problem.label, dtype),
        put(problem.sq_norm, dtype),
        torch.zeros((C, problem.rows_per_block), dtype=dtype, device=dev),
        int(config.seed),
    ]
    if inner == "gram":
        dev_args.append(build_gram(dev_args[1], dev_args[2],
                                   problem.n_features, dtype))
    if dw_mode != "direct":
        dev_args += sorted_layout(dev_args[1], dev_args[2],
                                  problem.n_features)
    return fit, dev_args


def svm_fit(
    data: SparseData,
    config: SVMConfig,
    device="cuda",
    problem: Optional[BlockedSVMProblem] = None,
    steps=None,
) -> SVMModel:
    """Train the CoCoA linear SVM on `device`; returns the dense primal
    weight vector (the reference's ``weightsOption: DataSet[DenseVector]``,
    SVMImpl.scala:31-35).  Without a `problem` the data is blocked by the
    device count, as in the reference; ``steps`` injects the step table
    (see ``fit``).  In a process group every rank calls this with the same
    inputs, runs its chains, and returns the same w."""
    dev = local_device(device)
    if problem is None:
        problem = prepare_svm_blocked(data, num_blocks(), seed=config.seed)
    fit, dev_args = compile_svm_fit(problem, config, dev)
    w, _alpha = fit(config.iterations, *dev_args, steps=steps)
    return SVMModel(weights=w.cpu().numpy().astype(np.float64))
