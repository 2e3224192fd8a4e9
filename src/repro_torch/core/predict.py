"""Block prediction with conditional simulation (paper Eq. 3 + §5.1.5).

Counterpart of ``repro.core.predict`` for the in-core layouts, uniform or
bucketed (``core.buckets``), at any precision-ladder tier:

    pack    -- test points are clustered into prediction blocks (bs_pred);
               each block conditions on its m_pred nearest TRAINING points
               (numpy, bitwise the reference's packing).
    predict -- one batched call over the packed arrays computes every block
               conditional (the fused CUDA kernel on the GPU, the plain
               version on the CPU), then the per-point simulation draws
               (paper §5.1.5: n_sims samples of N(mu_j, sigma_j^2)).
    scatter -- padded per-block results land back in test-point order.

Multi-output (an (n, p) training ``y``, ``MultiOutputParams``): one
training index and one Cholesky of the shared unit-variance conditioning
covariance per block serve all p outputs, through ``torch.linalg`` (cuSOLVER
on the GPU) as in the reference, where the fused predict kernels stay
single-output. An (n, 1) ``y`` squeezes to the single-output path.

Out of core: a row store for the training set (``y_train=None``) and/or
``stream_chunk`` builds the training index from mini-batch k-means passes
over the store, with candidate coordinates gathered on demand
(``data.streaming.LazyFlatBlocks``) and each chunk's neighbour rows
gathered once (``localize_neighbors``); a store ``x_test`` is read one
window at a time. The packed chunks are bitwise the in-core streaming
index's, and every chunk is still one predict kernel launch.

The reference draws its simulation noise from ``jax.random``; that stream
cannot be reproduced here, so ``predict_sbv`` takes an injected ``eps`` for
exact comparisons and otherwise draws from a ``torch.Generator`` on the
device, seeded from ``seed``, the chunk id and, on the bucketed layout,
the bucket id.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.store import as_store, is_store
from repro_torch.data.streaming import (DEFAULT_STRUCT_BATCH, LazyFlatBlocks,
                                        localize_neighbors, streaming_kmeans_blocks)
from repro_torch.device import resolve_device
from repro_torch.multihost import partition_blocks

from .blocks import BlockStructure, build_blocks, scale_inputs
from .kernels_math import KernelParams, cast_params
from .multioutput import MultiOutputParams, as_multi_params
from .nns import _FlatBlocks, filtered_knn_points
from .packing import PackedPrediction, pack_prediction, round_up
from .vecchia import _cholesky, _masked_cov, _solve_lower, narrow_factor

Z975 = 1.959963984540054


@dataclass
class Prediction:
    mean: np.ndarray       # conditional mean mu_new
    var: np.ndarray        # conditional marginal variance
    sim_mean: np.ndarray   # conditional-simulation sample mean
    ci_low: np.ndarray     # 95% CI bounds from simulation
    ci_high: np.ndarray


@dataclass
class TrainIndex:
    """Host-side training-set structure reused across prediction chunks.

    In-core indexes hold the raw and scaled arrays; store-backed indexes
    (``build_train_index(..., stream_chunk=)`` or a store) hold lazy row
    views with ``xs=None``, the store, and the scaled-domain volume the
    filtered kNN needs."""

    x: np.ndarray          # (n, d) raw training inputs (or lazy row view)
    y: np.ndarray          # (n,) training observations (or lazy row view)
    xs: np.ndarray | None  # (n, d) scaled inputs; None when store-backed
    beta: np.ndarray       # (d,) structure scaling
    blocks: BlockStructure # coarse blocks for the filtered kNN
    flat: _FlatBlocks | None = None  # flattened block members, built once
    store: object = None             # row store behind a streaming index
    domain_volume: float | None = None


def build_train_index(x_train, y_train, beta, m_pred: int, n_workers: int = 1,
                      seed: int = 0, stream_chunk: int | None = None) -> TrainIndex:
    """Scale + coarse-block the training set once; reused per chunk.

    A row store as ``x_train`` (``y_train=None``) and/or ``stream_chunk``
    builds the out-of-core index: mini-batch k-means passes over the store
    at the fixed structure batch (the index does not depend on the
    caller's window), and a flat index that gathers candidates from the
    store through a bounded cache. In-core arrays with ``stream_chunk`` run
    the same code over a ``MemoryStore``, so the two agree bitwise."""
    if is_store(x_train) or stream_chunk is not None:
        store = as_store(x_train, y_train)
        beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (store.d,))
        bc_train = max(1, store.n_rows // max(4 * m_pred, 64))
        blocks, radii, vol = streaming_kmeans_blocks(store, beta, bc_train, n_workers=n_workers,
                                                     seed=seed, batch_rows=DEFAULT_STRUCT_BATCH)
        return TrainIndex(x=store.x_rows, y=store.y_rows, xs=None, beta=beta, blocks=blocks,
                          flat=LazyFlatBlocks(blocks, radii, store, beta), store=store,
                          domain_volume=vol)
    x_train = np.asarray(x_train, dtype=np.float64)
    y_train = np.asarray(y_train, dtype=np.float64)
    beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (x_train.shape[1],))
    xs = scale_inputs(x_train, beta)
    bc_train = max(1, x_train.shape[0] // max(4 * m_pred, 64))
    blocks = build_blocks(xs, bc_train, n_workers, beta, seed=seed)
    return TrainIndex(x=x_train, y=y_train, xs=xs, beta=beta, blocks=blocks,
                      flat=_FlatBlocks(xs, blocks))


def scatter_packed(packed: PackedPrediction, *pairs) -> None:
    """Vectorized scatter: for each ``(padded_values, out)`` pair write
    ``out[q_idx[mask]] = padded_values[mask]`` (drops padding)."""
    msk = packed.q_mask
    idx = packed.q_idx[msk]
    for values, out in pairs:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        out[idx] = np.asarray(values)[msk]


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``.

    To a CUDA device the copy goes through pinned memory and does not block
    (it is ordered on the current stream), so the host never waits for the
    card's queued work; a plain ``.to(device)`` from pageable memory
    synchronises the stream."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def place_params(params, device: torch.device):
    """A parameter NamedTuple with every leaf a tensor on ``device``."""
    return type(params)(*(upload(torch.as_tensor(a), device) for a in params))


def upload_packed(packed: PackedPrediction, device: torch.device) -> tuple:
    """The five kernel operands of a packed chunk (or piece) on ``device``,
    each through ``upload``."""
    return tuple(upload(a, device) for a in packed.arrays())


def packed_predict(params, packed: PackedPrediction, nu: float = 3.5, backend: str = "auto",
                   device=None):
    """Mean and variance of a ``PackedPrediction`` (padded (bc, bs_pred)
    arrays, or (bc, bs_pred, p) for multi-output params) as tensors on
    ``device`` (default: the current CUDA device).

    Nothing here waits for the card: the operands go up through pinned
    memory (``upload``) and the conditional is queued on the current
    stream, so a caller overlaps the next chunk's host work with this one's
    compute and lands the result later."""
    dev = resolve_device(device)
    return batched_block_predict(place_params(params, dev), *upload_packed(packed, dev), nu=nu,
                                 backend=backend)


def pack_queries(index: TrainIndex, x_test, bs_pred: int, m_pred: int, alpha: float = 100.0,
                 seed: int = 0, n_workers: int = 1, offset: int = 0, pad_shapes: bool = False,
                 dtype=np.float64) -> PackedPrediction:
    """Cluster test points into prediction blocks, find each block's m_pred
    nearest training points, pack. ``offset`` shifts the scatter indices
    (chunked prediction). ``pad_shapes`` rounds bs/bc up to multiples of 8
    so successive chunks have the same shapes (as in the reference)."""
    x_test = np.asarray(x_test, dtype=np.float64)
    n_test = x_test.shape[0]
    xs_test = scale_inputs(x_test, index.beta)
    bc_pred = max(1, n_test // bs_pred)
    test_blocks = build_blocks(xs_test, bc_pred, n_workers, index.beta, seed=seed + 1)
    neigh = filtered_knn_points(index.xs, index.blocks, test_blocks.centers, m_pred, alpha,
                                flat=index.flat, domain_volume=index.domain_volume)
    if index.store is not None:
        # Gather the union of the neighbour rows once and remap (values and
        # order kept: the packed arrays are bit-identical).
        x_tr, y_tr, neigh = localize_neighbors(index.store, neigh)
    else:
        x_tr, y_tr = index.x, index.y
    bs_max = max(mb.size for mb in test_blocks.members)
    if pad_shapes:
        bs_max = round_up(bs_max, 8)
    packed = pack_prediction(x_test, x_tr, y_tr, test_blocks, neigh, m_pred,
                             bs_max=bs_max, dtype=dtype)
    if offset:
        packed.q_idx[packed.q_mask] += offset
    if pad_shapes:
        packed = packed.pad_to_blocks(round_up(packed.n_blocks, 8))
    return packed


def query_chunk_jobs(index: TrainIndex, x_test, bs_pred: int, m_pred: int,
                     alpha: float = 100.0, seed: int = 0, n_workers: int = 1,
                     chunk_size: int | None = None, dtype=np.float64):
    """Yield ``(chunk_id, pack)`` over the test set, where ``pack()`` reads
    the chunk's window and packs it (``iter_query_chunks``'s protocol), so
    a caller can run the packing on another thread."""
    if is_store(x_test):
        if chunk_size is None:
            raise ValueError("x_test is a store: pass chunk_size to bound the per-window read")
        n_test = x_test.n_rows
        window = lambda a, b: x_test.read_slice(a, b)[0]
    else:
        x_test = np.asarray(x_test, dtype=np.float64)
        n_test = x_test.shape[0]
        window = lambda a, b: x_test[a:b]
    step = n_test if chunk_size is None else max(int(chunk_size), bs_pred)
    for ci, start in enumerate(range(0, n_test, step)):
        stop = min(n_test, start + step)
        yield ci, (lambda ci=ci, start=start, stop=stop: pack_queries(
            index, window(start, stop), bs_pred, m_pred, alpha=alpha, seed=seed + ci,
            n_workers=n_workers, offset=start, pad_shapes=chunk_size is not None, dtype=dtype))


def iter_query_chunks(index: TrainIndex, x_test, bs_pred: int, m_pred: int,
                      alpha: float = 100.0, seed: int = 0, n_workers: int = 1,
                      chunk_size: int | None = None, dtype=np.float64):
    """Yield ``(chunk_id, PackedPrediction)`` over the test set, with the
    reference's chunking protocol: step clamped to >= bs_pred, per-chunk
    seed, scatter offsets, padded shapes in chunked mode. ``x_test`` may be
    a row store, read one window at a time (``chunk_size`` is then
    required)."""
    for ci, pack in query_chunk_jobs(index, x_test, bs_pred, m_pred, alpha=alpha, seed=seed,
                                     n_workers=n_workers, chunk_size=chunk_size, dtype=dtype):
        yield ci, pack()


def block_predict(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu: float = 3.5):
    """Plain batched block conditional: ``(mu, var)``, each (bc, bs).

    The counterpart of the reference's vmapped ``_predict_one`` and the
    plain version of the fused predict kernel."""
    q_mask = q_mask.bool()
    nn_mask = nn_mask.bool()
    sigma_con = _masked_cov(nn_x, nn_x, nn_mask, nn_mask, beta, sigma2, nugget, nu,
                            identity=True)
    sigma_cross = _masked_cov(nn_x, q_x, nn_mask, q_mask, beta, sigma2, nugget, nu,
                              identity=False)
    ynn = torch.where(nn_mask, nn_y, torch.zeros((), dtype=nn_y.dtype, device=nn_y.device))
    chol = _cholesky(sigma_con)
    a = _solve_lower(chol, sigma_cross)                  # (bc, m, bs)
    z = _solve_lower(chol, ynn[..., None])                # (bc, m, 1)
    # An elementwise product and sum, not a batched matmul, so that a block's
    # mean does not depend on how many blocks share the call (a batch of one
    # takes another BLAS path): a rank's span of a chunk gives the serial bits.
    mu = torch.sum(a * z, dim=-2)
    var = (sigma2 + nugget) - torch.sum(a * a, dim=-2)
    return mu, torch.clamp(var, min=1e-12)


def block_predict_narrow(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                         nu: float = 3.5):
    """``(mu, var)``, each (bc, bs), on the bf16-assembly tier: bf16
    coordinates, f32 observations, masks and parameters; the Pallas predict
    body with its pivot floor (see ``vecchia.narrow_factor``)."""
    m, bs = nn_x.shape[-2], q_x.shape[-2]
    zeros = torch.zeros(q_x.shape[:-1] + (1,), dtype=nn_y.dtype, device=nn_y.device)
    at = narrow_factor(beta, sigma2, nugget, nn_x, nn_mask.bool(), nn_y[..., None], q_x,
                       q_mask.bool(), zeros, nu, ncols=m)
    a = at[..., m:m + bs]                                # (bc, m, bs) = L^-1 K(NN, Q)
    z = at[..., m + bs]                                  # (bc, m)     = L^-1 y_NN
    mu = torch.sum(a * z[..., None], dim=-2) * q_mask.float()
    var = (sigma2 + nugget) - torch.sum(a * a, dim=-2)
    return mu, torch.clamp(var, min=1e-12)


def block_predict_multi(beta, tau2, sigma2, q_x, q_mask, nn_x, nn_y, nn_mask,
                        nu: float = 3.5):
    """Batched multi-output block conditional: ``(mu, var)``, each (bc, bs, p).

    The counterpart of the reference's vmapped ``_predict_multi_one``. One
    Cholesky of the shared unit-variance conditioning covariance serves all
    outputs: the mean is sigma2-free, so the p means are extra solve
    columns of ``nn_y`` (bc, m, p); the variance scales the shared
    unit-variance conditional by each output's ``sigma2`` (p,)."""
    q_mask = q_mask.bool()
    nn_mask = nn_mask.bool()
    one = torch.ones((), dtype=nn_y.dtype, device=nn_y.device)
    sigma_con = _masked_cov(nn_x, nn_x, nn_mask, nn_mask, beta, one, tau2, nu, identity=True)
    sigma_cross = _masked_cov(nn_x, q_x, nn_mask, q_mask, beta, one, tau2, nu, identity=False)
    ynn = torch.where(nn_mask[..., None], nn_y, torch.zeros((), dtype=nn_y.dtype,
                                                             device=nn_y.device))
    chol = _cholesky(sigma_con)
    a = _solve_lower(chol, sigma_cross)                  # (bc, m, bs)
    z = _solve_lower(chol, ynn)                          # (bc, m, p)
    mu = a.transpose(-1, -2) @ z                         # (bc, bs, p)
    var0 = (1.0 + tau2) - torch.sum(a * a, dim=-2)       # (bc, bs)
    return mu, torch.clamp(var0[..., None] * sigma2, min=1e-12)


def batched_block_predict(params: KernelParams | MultiOutputParams, q_x, q_mask, nn_x, nn_y,
                          nn_mask, nu: float = 3.5, backend: str = "auto"):
    """Conditional mean/variance of every prediction block: (bc, bs) each.
    Padded query slots carry mu=0 / var=prior; drop them with the mask.

    ``auto`` runs the fused kernel on CUDA tensors and the plain version on CPU
    tensors (``kernels.ops.sbv_predict_many``), at the observations' dtype, with
    the bf16-assembly variant for bf16 coordinates; ``ref`` runs the plain
    version directly (differentiable) at the promotion of the params' and
    the data's dtypes, as the reference's ``_predict_one`` does under jnp
    promotion. ``MultiOutputParams`` with (bc, m, p) ``nn_y`` take the
    shared-Cholesky multi-output conditional under every backend, at that
    promotion too, and give (bc, bs, p) each."""
    return batched_block_predict_many(params, [(q_x, q_mask, nn_x, nn_y, nn_mask)], nu=nu,
                                      backend=backend)[0]


def batched_block_predict_many(params: KernelParams | MultiOutputParams, pieces,
                               nu: float = 3.5, backend: str = "auto"):
    """``batched_block_predict`` of each piece of a chunk (``pieces``:
    ``(q_x, q_mask, nn_x, nn_y, nn_mask)`` tuples): a list of ``(mu, var)``.
    Single-output ``auto`` computes all pieces in one kernel launch
    (``kernels.ops.sbv_predict_many``); the other routes go piece by piece."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto" and not isinstance(params, MultiOutputParams):
        from repro_torch.kernels import ops

        return ops.sbv_predict_many(params, pieces, nu=nu)
    return [_plain_predict(params, *pc, nu=nu) for pc in pieces]


def _plain_predict(params, q_x, q_mask, nn_x, nn_y, nn_mask, nu: float):
    """The plain conditional of one piece at the promotion of the params'
    and the data's dtypes (multi-output: the shared-Cholesky form)."""
    wide = torch.promote_types(params.log_beta.dtype, nn_y.dtype)
    if isinstance(params, MultiOutputParams):
        p = MultiOutputParams(*(a.to(wide) for a in params))
        return block_predict_multi(p.beta, p.tau2, p.sigma2, q_x.to(wide), q_mask,
                                   nn_x.to(wide), nn_y.to(wide), nn_mask, nu=nu)
    p = cast_params(params, wide)
    return block_predict(p.beta, p.sigma2, p.nugget, q_x.to(wide), q_mask, nn_x.to(wide),
                         nn_y.to(wide), nn_mask, nu=nu)


def _simulate(mu, var, n_sims: int, eps=None, generator: torch.Generator | None = None):
    """Conditional simulation of one piece: ``(sim_mean, sim_std)`` of
    ``n_sims`` draws of N(mu, var). ``eps`` (n_sims, bc, bs[, p]) is the
    standard-normal noise; when it is None it is drawn from ``generator``
    on the device of ``mu``."""
    with torch.no_grad():
        if eps is None:
            eps = torch.randn((n_sims,) + tuple(mu.shape), generator=generator,
                              dtype=mu.dtype, device=mu.device)
        elif isinstance(eps, torch.Tensor):
            eps = eps.to(device=mu.device, dtype=mu.dtype)
        else:
            eps = torch.tensor(np.asarray(eps), device=mu.device, dtype=mu.dtype)
        draws = mu[None] + torch.sqrt(var)[None] * eps
        return draws.mean(dim=0), draws.std(dim=0, correction=1)


def _predict_and_simulate(params, q_x, q_mask, nn_x, nn_y, nn_mask, nu: float, backend: str,
                          n_sims: int, eps=None, generator: torch.Generator | None = None):
    """Per-chunk math: block conditionals + conditional simulation."""
    mu, var = batched_block_predict(params, q_x, q_mask, nn_x, nn_y, nn_mask, nu=nu,
                                    backend=backend)
    return (mu, var) + _simulate(mu, var, n_sims, eps=eps, generator=generator)


def _chunk_generator(seed: int, chunk_id: int, device: torch.device,
                     bucket_id: int | None = None) -> torch.Generator:
    """The simulation-noise generator of one chunk (uniform layout) or of
    one bucket of a chunk (bucketed layout: an independent stream per
    bucket, as the reference folds the bucket index into the chunk key)."""
    words = [seed, chunk_id] if bucket_id is None else [seed, chunk_id, bucket_id]
    state = np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def _slice_prediction_blocks(p: PackedPrediction, lo: int, hi: int) -> PackedPrediction:
    """A contiguous block-row view of a packed chunk (every field's leading
    axis is the block count; ``q_idx`` stays global, so the scatter of a
    slice lands in the right test rows)."""
    if (lo, hi) == (0, p.n_blocks):
        return p
    return PackedPrediction(q_x=p.q_x[lo:hi], q_mask=p.q_mask[lo:hi], q_idx=p.q_idx[lo:hi],
                            nn_x=p.nn_x[lo:hi], nn_y=p.nn_y[lo:hi], nn_mask=p.nn_mask[lo:hi],
                            owners=p.owners[lo:hi])


def predict_sbv(
    params: KernelParams | MultiOutputParams,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray,
    bs_pred: int = 25,
    m_pred: int = 200,
    nu: float = 3.5,
    alpha: float = 100.0,
    n_sims: int = 1000,
    seed: int = 0,
    n_workers: int = 1,
    beta_struct: np.ndarray | None = None,
    backend: str = "auto",
    chunk_size: int | None = None,
    dtype=np.float64,
    device=None,
    eps=None,
    n_buckets: int | None = None,
    stream_chunk: int | None = None,
    precision=None,
    tuning=None,
    multihost=None,
) -> Prediction:
    """Packed block prediction over the full test set.

    Runs on ``device`` (default: the current CUDA device; with no GPU pass
    ``device='cpu'``). ``beta_struct`` overrides the scaling used for
    clustering/NNS only. ``chunk_size`` streams the test set through
    fixed-shape chunks so device memory stays bounded. ``eps``, when given,
    is a callable ``eps(chunk_id, bucket_id, shape)`` returning the
    (n_sims, bc, bs[, p]) standard-normal draws of that chunk
    (``bucket_id`` None) or of that bucket of the chunk (tests inject the
    reference's draws); otherwise each chunk, or bucket, draws from its own
    device generator.

    ``n_buckets`` runs each chunk as size-buckets padded to their own
    ceilings (``core.buckets``), all of a chunk's buckets in one kernel
    launch; mean and variance equal the uniform layout's. ``precision`` (a
    ladder tier or a ``PrecisionPolicy``) packs the queries at the tier's
    accumulation dtype and casts each piece's coordinates to its storage
    dtype (bf16: the kernels' bf16-assembly variant); no probe runs here:
    pass the fitted tier.

    An (n, p) ``y_train`` predicts all p outputs from one training index
    with ``MultiOutputParams`` (a ``KernelParams`` is broadcast over the
    outputs); every result is then (n_test, p). An (n, 1) ``y_train`` runs
    the single-output path and returns (n_test, 1) results.

    Out of core: ``x_train`` (with ``y_train=None``) and/or ``x_test`` may
    be row stores, and ``stream_chunk`` selects the streaming training index
    (``build_train_index``); in-core arrays with ``stream_chunk`` take the
    identical code, so store-backed and in-core streaming predictions agree
    bitwise. A store ``x_test`` without ``chunk_size`` is read in windows of
    ``stream_chunk`` rows.

    ``multihost`` (a ``repro_torch.multihost`` comm) shards every chunk's
    prediction BLOCKS by rank: each rank computes its contiguous block span
    of every piece (``multihost.partition_blocks``; one predict launch per
    chunk for all of its spans), draws the WHOLE chunk's simulation noise
    and keeps its span's rows, so every block gets the serial path's
    draws, scatters into zero-filled result columns, and ONE all-reduce
    sum per call merges the disjoint columns (x + 0 is exact, so the sum
    IS an all-gather). Every rank must pass identical training and test
    data; all ranks return the full result: mean and variance bitwise the
    serial call's, the simulation columns equal up to the reductions'
    order. A ``LoopbackComm`` reproduces the serial call bitwise.

    ``tuning`` (a ``TuningRecord``, its dict, or a checkpoint directory or
    json path, from either package) fills ``n_buckets``, ``stream_chunk``
    and ``precision`` where unset, and ``backend`` when it is ``'auto'``
    (``tuning.apply_record``: the precision is the tier the record's
    buckets settled at, since nothing probes here); explicit arguments win
    over the record."""
    if tuning is not None:
        from repro_torch.tuning import apply_record

        n_buckets, stream_chunk, precision, backend = apply_record(
            tuning, n_buckets=n_buckets, stream_chunk=stream_chunk, precision=precision,
            backend=backend)
    tier = None
    if precision is not None:
        from .buckets import acc_dtype, as_policy

        pol = as_policy(precision)
        if pol.tier != "f64":
            tier = pol.tier
            dtype = acc_dtype(tier)  # queries pack at the accumulation width
    n_outputs = 1
    squeeze_back = False
    if is_store(x_train):
        y0 = np.asarray(as_store(x_train, y_train).read_slice(0, 1)[1])
        if y0.ndim == 2:
            n_outputs = y0.shape[1]
    else:
        y_train = np.asarray(y_train)
        squeeze_back = y_train.ndim == 2 and y_train.shape[1] == 1
        if squeeze_back:
            y_train = y_train[:, 0]
        elif y_train.ndim == 2:
            n_outputs = y_train.shape[1]
    dev = resolve_device(device)
    params = type(params)(*(torch.as_tensor(a).to(dev) for a in params))
    if n_outputs > 1:
        params = as_multi_params(params, n_outputs, params.log_beta.shape[0])
    elif isinstance(params, MultiOutputParams):
        params = params.output_params(0)
    beta = params.beta.detach().cpu().numpy() if beta_struct is None else beta_struct
    if is_store(x_test):
        n_test = x_test.n_rows
        if chunk_size is None:
            chunk_size = stream_chunk  # bound the test-window reads too
    else:
        x_test = np.asarray(x_test, dtype=np.float64)
        n_test = x_test.shape[0]
    index = build_train_index(x_train, y_train, np.asarray(beta), m_pred, n_workers, seed,
                              stream_chunk=stream_chunk)

    out_shape = (n_test,) if n_outputs == 1 else (n_test, n_outputs)
    mean, var, sim_mean, sim_std = (np.zeros(out_shape) for _ in range(4))
    for ci, packed in iter_query_chunks(index, x_test, bs_pred, m_pred, alpha=alpha,
                                        seed=seed, n_workers=n_workers,
                                        chunk_size=chunk_size, dtype=dtype):
        if n_buckets:
            from .buckets import bucket_mults, bucket_prediction

            bs_mult, m_mult = bucket_mults(backend, precision=tier)
            pieces = bucket_prediction(packed, n_buckets=n_buckets, bs_mult=bs_mult,
                                       m_mult=m_mult).buckets
        else:
            pieces = [packed]
        if tier is not None:
            from .buckets import cast_prediction

            pieces = [cast_prediction(pc, tier) for pc in pieces]
        # Each piece's block span on this rank (all of it without a comm).
        spans = [(0, pc.n_blocks) if multihost is None
                 else partition_blocks(pc.n_blocks, multihost.size)[multihost.rank]
                 for pc in pieces]
        work = [(bi, _slice_prediction_blocks(pc, lo, hi), lo)
                for bi, (pc, (lo, hi)) in enumerate(zip(pieces, spans)) if hi > lo]
        if not work:
            continue
        arrs = [tuple(torch.as_tensor(a).to(dev) for a in sub.arrays()) for _, sub, _ in work]
        conds = batched_block_predict_many(params, arrs, nu=nu, backend=backend)
        for (bi, sub, lo), (mu_b, var_b) in zip(work, conds):
            # The uniform layout keeps the per-chunk stream; buckets draw
            # from independent per-bucket streams, as in the reference. A
            # span takes its rows of the whole piece's draws.
            b_id = bi if n_buckets else None
            shape = (n_sims,) + pieces[bi].q_mask.shape + out_shape[1:]
            if eps is not None:
                eps_c = eps(ci, b_id, shape)
            else:
                eps_c = torch.randn(shape, generator=_chunk_generator(seed, ci, dev, b_id),
                                    dtype=mu_b.dtype, device=dev)
            sm_b, ss_b = _simulate(mu_b, var_b, n_sims,
                                   eps=eps_c[:, lo:lo + sub.n_blocks])
            scatter_packed(sub, (mu_b, mean), (var_b, var), (sm_b, sim_mean),
                           (ss_b, sim_std))
    if multihost is not None:
        # Ranks filled disjoint result rows; one all-reduce sum of the
        # zero-initialized columns is an exact all-gather.
        mean, var, sim_mean, sim_std = multihost.allreduce(
            np.stack([mean, var, sim_mean, sim_std]))
    if squeeze_back:
        mean, var, sim_mean, sim_std = (a[:, None] for a in (mean, var, sim_mean, sim_std))
    return Prediction(mean=mean, var=var, sim_mean=sim_mean,
                      ci_low=sim_mean - Z975 * sim_std, ci_high=sim_mean + Z975 * sim_std)


def mspe(pred: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean((pred - truth) ** 2))


def rmspe(pred: np.ndarray, truth: np.ndarray) -> float:
    """Root Mean Squared Percentage Error (paper §6.2)."""
    denom = np.where(np.abs(truth) > 1e-12, truth, 1.0)
    return float(np.sqrt(np.mean(((pred - truth) / denom) ** 2)) * 100.0)
