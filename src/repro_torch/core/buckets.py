"""Bucketed variable-size block execution and the precision ladder.

Counterpart of ``repro.core.buckets`` (numpy, bucket partitions bitwise
the reference's). A uniformly padded batch pads every block to the global
``bs_max`` and ``m``; the bucketed layout partitions the blocks into K
size-buckets with geometric (bs, m) ceilings, each a small ``PackedBlocks``
/ ``PackedPrediction`` padded only to its own ceiling, with ``ranks``
scatter indices back to the uniform order. Every consumer loops the
buckets (one kernel launch per bucket; a prediction chunk's buckets share
one launch) and sums log-likelihoods or scatters predictions; identity
padding makes the result equal to the
uniform layout's (1e-10 in f64), so only the padded work changes, which
``occupancy`` (true FLOPs / padded FLOPs) measures.

The precision ladder names a bucket's covariance-assembly tier:

    tier    coordinates stored/assembled    observations, params, accumulation
    bf16    bfloat16                        float32
    f32     float32                         float32
    f64     float64                         float64

numpy has no bfloat16 of its own (the reference gets one from JAX), so the
bf16 tier's coordinates are ``torch.bfloat16`` tensors, converted from the
packed float64 arrays: that rounds through float32, bitwise as the
reference's ``astype(jnp.bfloat16)`` does. Every other field stays numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .packing import PackedBlocks, PackedPrediction, round_up


def bucket_mults(backend: str, precision: str | None = None) -> tuple[int, int]:
    """(bs_mult, m_mult) bucket-ceiling alignment for a kernel backend.

    The CUDA kernels take any bs and m (their panels mask the ragged
    edge), so every backend and tier buckets to exact geometric ceilings.
    The reference's TPU tiles ((8, 128), (16, 128) for bf16) are not
    copied."""
    return 1, 1


def block_flops(bs, m):
    """Per-block likelihood work model: bs * (bs + m)^2."""
    s = np.asarray(bs, dtype=np.float64)
    t = np.asarray(m, dtype=np.float64)
    return s * (s + t) ** 2


def predict_flops(bs, m):
    """Per-block prediction work model: chol(m) + joint solve vs bs RHS."""
    s = np.asarray(bs, dtype=np.float64)
    t = np.asarray(m, dtype=np.float64)
    return t ** 3 / 3.0 + t * t * s + t * s


def bucket_ceilings(sizes: np.ndarray, n_buckets: int, mult: int = 1) -> np.ndarray:
    """Geometric bucket ceilings covering ``sizes``, rounded up to ``mult``:
    a sorted array of at most ``n_buckets`` distinct ceilings, the last
    covering ``max(sizes)``. Uniform sizes collapse to one bucket."""
    sizes = np.asarray(sizes)
    if sizes.size == 0:
        return np.asarray([mult], dtype=np.int64)
    lo = max(int(sizes.min()), 1)
    hi = max(int(sizes.max()), 1)
    if n_buckets <= 1 or hi <= lo:
        return np.asarray([round_up(hi, mult)], dtype=np.int64)
    edges = np.geomspace(lo, hi, num=n_buckets + 1)[1:]
    ceils = sorted({round_up(int(np.ceil(e)), mult) for e in edges})
    if ceils[-1] < hi:
        ceils.append(round_up(hi, mult))
    return np.asarray(ceils, dtype=np.int64)


def assign_buckets(sizes: np.ndarray, ceilings: np.ndarray) -> np.ndarray:
    """Index of the smallest ceiling >= each size."""
    idx = np.searchsorted(ceilings, np.asarray(sizes))
    if idx.size and idx.max() >= ceilings.size:
        raise ValueError("size exceeds the largest bucket ceiling")
    return idx


def _true_sizes(mask: np.ndarray) -> np.ndarray:
    """Per-row count of real entries; masks must be contiguous prefixes
    (the packing contract every bucket slice relies on)."""
    counts = mask.sum(axis=1).astype(np.int64)
    expect = np.arange(mask.shape[1])[None, :] < counts[:, None]
    if not np.array_equal(mask.astype(bool), expect):
        raise ValueError("mask is not a contiguous prefix; cannot bucket")
    return counts


@dataclass
class BucketedBlocks:
    """K per-shape batches replacing one uniformly padded batch.

    ``buckets[k]`` is a ``PackedBlocks`` padded to its own (bs, m) ceiling;
    ``ranks[k]`` holds each block's index in the source uniform layout
    (its conditioning rank), the scatter index back to global order."""

    buckets: list
    ranks: list

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_blocks(self) -> int:
        return sum(pk.n_blocks for pk in self.buckets)

    @property
    def n_points(self) -> int:
        return sum(pk.n_points for pk in self.buckets)

    def occupancy(self) -> float:
        """True/padded FLOP ratio under the likelihood work model."""
        true, padded = loglik_work(self.buckets)
        return true / padded if padded else 1.0


@dataclass
class BucketedPrediction:
    """Prediction twin of ``BucketedBlocks``; each bucket keeps its global
    ``q_idx``, so its results scatter straight into test-point order."""

    buckets: list
    ranks: list

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_blocks(self) -> int:
        return sum(pk.n_blocks for pk in self.buckets)

    @property
    def n_queries(self) -> int:
        return sum(pk.n_queries for pk in self.buckets)

    def occupancy(self) -> float:
        """True/padded FLOP ratio under the prediction work model."""
        true, padded = prediction_work(self.buckets)
        return true / padded if padded else 1.0


def loglik_work(buckets: list) -> tuple[float, float]:
    """(true, padded) likelihood FLOPs over a list of ``PackedBlocks``."""
    true = padded = 0.0
    for pk in buckets:
        bs_t = pk.blk_mask.sum(axis=1)
        m_t = pk.nn_mask.sum(axis=1)
        true += float(np.sum(block_flops(bs_t, m_t)))
        padded += pk.n_blocks * float(block_flops(pk.bs_max, pk.m))
    return true, padded


def prediction_work(buckets: list) -> tuple[float, float]:
    """(true, padded) prediction FLOPs over a list of ``PackedPrediction``."""
    true = padded = 0.0
    for pk in buckets:
        bs_t = pk.q_mask.sum(axis=1)
        m_t = pk.nn_mask.sum(axis=1)
        true += float(np.sum(predict_flops(bs_t, m_t)))
        padded += pk.n_blocks * float(predict_flops(pk.bs_pred, pk.m_pred))
    return true, padded


def _group(bs_true, m_true, bs_ceils, m_ceils):
    """Block indices grouped by (bs-ceiling, m-ceiling) cell, in sorted
    cell order (a deterministic bucket sequence)."""
    bs_a = assign_buckets(bs_true, bs_ceils)
    m_a = assign_buckets(m_true, m_ceils)
    cells: dict[tuple[int, int], list[int]] = {}
    for b, key in enumerate(zip(bs_a.tolist(), m_a.tolist())):
        cells.setdefault(key, []).append(b)
    out = []
    for key in sorted(cells):
        idx = np.asarray(cells[key], dtype=np.int64)
        out.append((int(bs_ceils[key[0]]), int(m_ceils[key[1]]), idx))
    return out


def bucket_blocks(packed: PackedBlocks, n_buckets: int = 4, bs_mult: int = 1, m_mult: int = 1,
                  ceilings: tuple[np.ndarray, np.ndarray] | None = None) -> BucketedBlocks:
    """Partition a uniformly padded ``PackedBlocks`` into size-buckets.

    ``n_buckets`` bounds the geometric levels per dimension (bs and m);
    the realized bucket count is the number of occupied (bs, m) cells.
    ``bs_mult`` / ``m_mult`` align the ceilings; ``ceilings=(bs_ceils,
    m_ceils)`` replaces the per-call ceilings with precomputed ones."""
    bs_true = _true_sizes(packed.blk_mask)
    m_true = _true_sizes(packed.nn_mask)
    if ceilings is not None:
        bs_ceils, m_ceils = ceilings
    else:
        bs_ceils = bucket_ceilings(bs_true, n_buckets, bs_mult)
        m_ceils = bucket_ceilings(m_true, n_buckets, m_mult)

    buckets, ranks = [], []
    for bs_c, m_c, idx in _group(bs_true, m_true, bs_ceils, m_ceils):
        bs_c = min(bs_c, packed.bs_max)
        m_c = min(m_c, packed.m)
        buckets.append(PackedBlocks(
            blk_x=packed.blk_x[idx, :bs_c], blk_y=packed.blk_y[idx, :bs_c],
            blk_mask=packed.blk_mask[idx, :bs_c], nn_x=packed.nn_x[idx, :m_c],
            nn_y=packed.nn_y[idx, :m_c], nn_mask=packed.nn_mask[idx, :m_c],
            owners=packed.owners[idx]))
        ranks.append(idx)
    return BucketedBlocks(buckets=buckets, ranks=ranks)


def bucket_prediction(packed: PackedPrediction, n_buckets: int = 4, bs_mult: int = 1,
                      m_mult: int = 1) -> BucketedPrediction:
    """Prediction twin of ``bucket_blocks`` (same ceiling policy)."""
    bs_true = _true_sizes(packed.q_mask)
    m_true = _true_sizes(packed.nn_mask)
    bs_ceils = bucket_ceilings(bs_true, n_buckets, bs_mult)
    m_ceils = bucket_ceilings(m_true, n_buckets, m_mult)

    buckets, ranks = [], []
    for bs_c, m_c, idx in _group(bs_true, m_true, bs_ceils, m_ceils):
        bs_c = min(bs_c, packed.bs_pred)
        m_c = min(m_c, packed.m_pred)
        buckets.append(PackedPrediction(
            q_x=packed.q_x[idx, :bs_c], q_mask=packed.q_mask[idx, :bs_c],
            q_idx=packed.q_idx[idx, :bs_c], nn_x=packed.nn_x[idx, :m_c],
            nn_y=packed.nn_y[idx, :m_c], nn_mask=packed.nn_mask[idx, :m_c],
            owners=packed.owners[idx]))
        ranks.append(idx)
    return BucketedPrediction(buckets=buckets, ranks=ranks)


# -- the precision ladder --------------------------------------------------

LADDER = ("bf16", "f32", "f64")  # narrowest -> widest demotion order

# Per-tier relative nll error budgets against the f64 value: f32 at the
# kernel-vs-plain parity class (1e-6), bf16 at the coordinate rounding's
# class (bf16 rounds at ~4e-3 relative).
_TIER_BUDGETS = {"bf16": 5e-3, "f32": 1e-6, "f64": 0.0}


def storage_dtype(tier: str):
    """Coordinate (assembly) dtype of a ladder tier: ``torch.bfloat16`` for
    bf16, numpy float32 / float64 otherwise."""
    return {"bf16": torch.bfloat16, "f32": np.float32, "f64": np.float64}[tier]


def acc_dtype(tier: str):
    """Accumulation dtype of a ladder tier (observations, params)."""
    return {"bf16": np.float32, "f32": np.float32, "f64": np.float64}[tier]


def dtype_tier(dt) -> str:
    """Inverse of ``storage_dtype``: the tier a packed piece runs at, read
    off its coordinate dtype (numpy or torch)."""
    if isinstance(dt, torch.dtype):
        return {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}.get(
            dt, str(dt))
    name = np.dtype(dt).name
    return {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}.get(name, name)


@dataclass(frozen=True)
class PrecisionPolicy:
    """Per-bucket precision selection for the likelihood/prediction ladder.

    ``tier`` is the requested assembly tier; with ``probe=True``
    ``assign_precision`` evaluates each bucket's nll at the candidate tier
    through the same packed program the fit runs, compares it with the f64
    value, and demotes the bucket one rung at a time (bf16 -> f32 -> f64)
    until the relative error fits the tier's budget. ``error_budget``
    replaces the per-tier budgets with one bound for every rung."""

    tier: str = "f32"
    error_budget: float | None = None
    probe: bool = True

    def __post_init__(self):
        if self.tier not in LADDER:
            raise ValueError(f"unknown precision tier {self.tier!r}; expected one of {LADDER}")

    def budget_for(self, tier: str) -> float:
        if self.error_budget is not None:
            return float(self.error_budget)
        return _TIER_BUDGETS[tier]


def as_policy(precision) -> PrecisionPolicy:
    """Coerce a tier name / None / policy into a ``PrecisionPolicy``."""
    if precision is None:
        return PrecisionPolicy(tier="f64", probe=False)
    if isinstance(precision, PrecisionPolicy):
        return precision
    return PrecisionPolicy(tier=str(precision))


def _cast_coords(a, tier: str):
    """Coordinates at a tier's storage dtype: numpy for f32/f64, a
    ``torch.bfloat16`` tensor for bf16."""
    if tier == "bf16":
        if isinstance(a, torch.Tensor):
            return a.to(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(torch.bfloat16)
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(a, dtype=storage_dtype(tier))


def cast_packed(pk: PackedBlocks, tier: str) -> PackedBlocks:
    """Cast one likelihood bucket to a ladder tier: coordinates to the
    tier's storage dtype, observations to its accumulation dtype; boolean
    masks and owners are untouched."""
    ac = acc_dtype(tier)
    return PackedBlocks(
        blk_x=_cast_coords(pk.blk_x, tier), blk_y=np.asarray(pk.blk_y, dtype=ac),
        blk_mask=pk.blk_mask, nn_x=_cast_coords(pk.nn_x, tier),
        nn_y=np.asarray(pk.nn_y, dtype=ac), nn_mask=pk.nn_mask, owners=pk.owners)


def cast_prediction(pk: PackedPrediction, tier: str) -> PackedPrediction:
    """Prediction twin of ``cast_packed`` (q_idx stays integral)."""
    ac = acc_dtype(tier)
    return PackedPrediction(
        q_x=_cast_coords(pk.q_x, tier), q_mask=pk.q_mask, q_idx=pk.q_idx,
        nn_x=_cast_coords(pk.nn_x, tier), nn_y=np.asarray(pk.nn_y, dtype=ac),
        nn_mask=pk.nn_mask, owners=pk.owners)


def assign_precision(params, bucketed, policy: PrecisionPolicy, nu: float = 3.5,
                     backend: str = "auto") -> list:
    """Per-bucket ladder tiers under ``policy``, enforced by probing.

    Accepts a ``BucketedBlocks`` or one ``PackedBlocks`` (one bucket). Each
    bucket's nll at the candidate tier runs through ``packed_loglik`` (the
    kernel route under ``'auto'``, as the fit) and is compared with its f64
    value; an over-budget bucket demotes one rung at a time. Returns the
    tier names aligned with the buckets."""
    from .vecchia import packed_loglik

    buckets = bucketed.buckets if isinstance(bucketed, BucketedBlocks) else [bucketed]
    tiers = []
    with torch.no_grad():
        for pk in buckets:
            tier = policy.tier
            if tier == "f64" or not policy.probe:
                tiers.append(tier)
                continue
            ref = float(packed_loglik(params, cast_packed(pk, "f64"), nu=nu, backend=backend))
            denom = max(1.0, abs(ref))
            while tier != "f64":
                got = float(packed_loglik(params, cast_packed(pk, tier), nu=nu, backend=backend))
                if abs(got - ref) / denom <= policy.budget_for(tier):
                    break
                tier = LADDER[LADDER.index(tier) + 1]
            tiers.append(tier)
    return tiers


def apply_precision(bucketed: BucketedBlocks, tiers) -> BucketedBlocks:
    """Cast every bucket to its assigned tier (see ``assign_precision``)."""
    if isinstance(tiers, str):
        tiers = [tiers] * bucketed.n_buckets
    if len(tiers) != bucketed.n_buckets:
        raise ValueError(f"{len(tiers)} tiers for {bucketed.n_buckets} buckets")
    return BucketedBlocks(buckets=[cast_packed(pk, t) for pk, t in zip(bucketed.buckets, tiers)],
                          ranks=bucketed.ranks)
