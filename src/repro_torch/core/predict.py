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

from repro_torch.device import resolve_device

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
    """Host-side training-set structure reused across prediction chunks."""

    x: np.ndarray          # (n, d) raw training inputs
    y: np.ndarray          # (n,) training observations
    xs: np.ndarray         # (n, d) scaled inputs
    beta: np.ndarray       # (d,) structure scaling
    blocks: BlockStructure # coarse blocks for the filtered kNN
    flat: _FlatBlocks      # flattened block members, built once
    domain_volume: float | None = None


def build_train_index(x_train, y_train, beta, m_pred: int, n_workers: int = 1,
                      seed: int = 0, stream_chunk: int | None = None) -> TrainIndex:
    """Scale + coarse-block the training set once; reused per chunk."""
    if stream_chunk is not None:
        raise NotImplementedError("store-backed (streaming) training indexes are not ported")
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
    bs_max = max(mb.size for mb in test_blocks.members)
    if pad_shapes:
        bs_max = round_up(bs_max, 8)
    packed = pack_prediction(x_test, index.x, index.y, test_blocks, neigh, m_pred,
                             bs_max=bs_max, dtype=dtype)
    if offset:
        packed.q_idx[packed.q_mask] += offset
    if pad_shapes:
        packed = packed.pad_to_blocks(round_up(packed.n_blocks, 8))
    return packed


def iter_query_chunks(index: TrainIndex, x_test, bs_pred: int, m_pred: int,
                      alpha: float = 100.0, seed: int = 0, n_workers: int = 1,
                      chunk_size: int | None = None, dtype=np.float64):
    """Yield ``(chunk_id, PackedPrediction)`` over the test set, with the
    reference's chunking protocol: step clamped to >= bs_pred, per-chunk
    seed, scatter offsets, padded shapes in chunked mode."""
    x_test = np.asarray(x_test, dtype=np.float64)
    n_test = x_test.shape[0]
    step = n_test if chunk_size is None else max(int(chunk_size), bs_pred)
    for ci, start in enumerate(range(0, n_test, step)):
        stop = min(n_test, start + step)
        yield ci, pack_queries(index, x_test[start:stop], bs_pred, m_pred, alpha=alpha,
                               seed=seed + ci, n_workers=n_workers, offset=start,
                               pad_shapes=chunk_size is not None, dtype=dtype)


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
    mu = (a.transpose(-1, -2) @ z)[..., 0]
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

    Streaming indexes, tuning records and multi-host sharding are not
    ported yet and raise ``NotImplementedError``."""
    for name, val in (("stream_chunk", stream_chunk), ("tuning", tuning),
                      ("multihost", multihost)):
        if val is not None:
            raise NotImplementedError(f"predict_sbv({name}=) is not ported yet")
    tier = None
    if precision is not None:
        from .buckets import acc_dtype, as_policy

        pol = as_policy(precision)
        if pol.tier != "f64":
            tier = pol.tier
            dtype = acc_dtype(tier)  # queries pack at the accumulation width
    y_train = np.asarray(y_train)
    n_outputs = 1
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
    x_test = np.asarray(x_test, dtype=np.float64)
    n_test = x_test.shape[0]
    index = build_train_index(x_train, y_train, np.asarray(beta), m_pred, n_workers, seed)

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
        arrs = [tuple(torch.as_tensor(a).to(dev) for a in piece.arrays()) for piece in pieces]
        conds = batched_block_predict_many(params, arrs, nu=nu, backend=backend)
        for bi, (piece, (mu_b, var_b)) in enumerate(zip(pieces, conds)):
            # The uniform layout keeps the per-chunk stream; buckets draw
            # from independent per-bucket streams, as in the reference.
            b_id = bi if n_buckets else None
            shape = (n_sims,) + piece.q_mask.shape + out_shape[1:]
            eps_c = None if eps is None else eps(ci, b_id, shape)
            gen = None if eps_c is not None else _chunk_generator(seed, ci, dev, b_id)
            sm_b, ss_b = _simulate(mu_b, var_b, n_sims, eps=eps_c, generator=gen)
            scatter_packed(piece, (mu_b, mean), (var_b, var), (sm_b, sim_mean),
                           (ss_b, sim_std))
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
