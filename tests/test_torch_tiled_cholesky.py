"""Port vs reference: the GP kernels' tiled elimination order, on the CPU.

``vecchia.tiled_cholesky_`` is the plain mirror of the factorization core
of the likelihood, prediction and multi-output kernels (``tiled_cholesky``
in src/repro_torch/csrc/sbv_common.cuh: left-looking panels of 32 columns,
the diagonal tile factored column by column with every pivot clamped at the
floor, the rows below it solved against it with its inverse diagonal). It
is held to the reference on the same numpy inputs:

* the factor, and the forward solve of the extra rows, against the Pallas
  body's ``_cholesky_inplace`` / ``_forward_sub`` through JAX, in f64 at
  1e-10 of the factor's scale, with the pivot floor at 1e-30 and with a floor
  that clamps pivots (the bf16 tier's ``2^-7 * sigma2`` against a matrix
  whose small pivots lie far below it, so both orders clamp the same ones);
* the block log-likelihood through the tiled elimination of the joint
  matrix (the observations as an extra row) against ``sbv_loglik_pallas`` in
  interpret mode, in f64 at 1e-10;
* the prediction and the multi-output stats as their kernels compute them:
  the masked points dropped on the host (the kernels leave them out), the
  compacted joint matrix factored by ``tiled_cholesky_`` (prediction over
  its m_real neighbour columns, the p observation rows riding along for the
  stats), against ``sbv_predict_pallas`` and ``sbv_multi_stats_pallas`` in
  interpret mode, which factor the padded blocks, in f64 at rtol 1e-10,
  with holes in both masks, a block with every query (block point) masked
  and a block with no real neighbour;

at P = m + bs below, at and one above the panel width, across several
panels, and with m = 4 (the round-0 bucket's neighbour count). The bf16
tier's plain versions (``block_loglik_narrow``, ``block_multi_stats_narrow``,
``block_predict_narrow``) run this order; they are held to the reference's
interpret-mode kernels in test_torch_precision.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.kernels.sbv_loglik import (_cholesky_inplace, _forward_sub,  # noqa: E402
                                      sbv_loglik_pallas, sbv_multi_stats_pallas)
from repro.kernels.sbv_predict import sbv_predict_pallas  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import multioutput, predict, vecchia  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_route  # noqa: E402

F64 = torch.float64


def _spd(n: int, n_small: int, seed: int) -> np.ndarray:
    """An n x n SPD matrix with eigenvalues in [0.5, 2] but ``n_small`` of
    them at 1e-6 (pivots that a floor of 1e-2 clamps)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = rng.uniform(0.5, 2.0, size=n)
    ev[rng.choice(n, size=n_small, replace=False)] = 1e-6
    return (q * ev) @ q.T


@pytest.mark.parametrize("floor", [1e-30, 1e-2])
@pytest.mark.parametrize("n", [20, 32, 33, 70, 97])
def test_tiled_cholesky_matches_reference_factor(n, floor):
    a = _spd(n, 3 if floor > 1e-20 else 0, seed=n)
    rhs = np.random.default_rng(n + 1).normal(size=(2, n))
    # A with the two right-hand sides as extra rows, stored transposed.
    at = torch.as_tensor(np.concatenate([a, rhs], axis=0).T.copy())
    vecchia.tiled_cholesky_(at, n, torch.tensor(floor, dtype=F64))
    l_ref = np.asarray(_cholesky_inplace(jnp.asarray(a), floor=floor))
    z_ref = np.asarray(_forward_sub(jnp.asarray(l_ref), jnp.asarray(rhs.T)))
    got = at.numpy()
    lower = np.tril(np.ones((n, n), dtype=bool))
    scale = np.abs(l_ref).max()
    np.testing.assert_allclose(got[:, :n].T[lower], l_ref[lower], rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got[:, n:], z_ref, rtol=0, atol=1e-10 * np.abs(z_ref).max())
    if floor > 1e-20:  # the floor engaged: some pivots are exactly sqrt(floor)
        assert np.sum(np.isclose(np.diag(l_ref), np.sqrt(floor), rtol=1e-12)) >= 1


def _case(bs, m, bc=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(240, 3))
    y = rng.normal(size=240)
    beta = np.linspace(0.3, 2.0, 3)
    packed, _ = ref_preprocess(x, y, beta, RefConfig(n_blocks=8, m=m, seed=seed))
    ref_p = RefParams.create(sigma2=1.4, beta=beta, nugget=1e-2)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    arrs = [a[:bc] for a in (packed.blk_x[:, :bs], packed.blk_y[:, :bs],
                             packed.blk_mask[:, :bs], packed.nn_x, packed.nn_y, packed.nn_mask)]
    return ref_p, p, arrs


def _tiled_loglik(p, arrs, nu):
    """Per-block log-densities through ``tiled_cholesky_`` of the f64 joint
    matrix [neighbours; block] with the observations as an extra row."""
    bx, by, bm, nx, ny, nm = (torch.as_tensor(np.asarray(a)) for a in arrs)
    bm, nm = bm.bool(), nm.bool()
    m, pp = nx.shape[1], nx.shape[1] + bx.shape[1]
    x, msk = torch.cat([nx, bx], dim=1), torch.cat([nm, bm], dim=1)
    y = torch.where(msk, torch.cat([ny, by], dim=1), torch.zeros((), dtype=F64))
    k = vecchia._masked_cov(x, x, msk, msk, p.beta, p.sigma2, p.nugget, nu, identity=True)
    at = vecchia.tiled_cholesky_(torch.cat([k, y[..., None]], dim=-1), pp,
                                 torch.tensor(1e-30, dtype=F64))
    diag = torch.diagonal(at, dim1=-2, dim2=-1)[..., m:]
    v = at[..., m:, pp]
    mb = bm.to(F64)
    return (-0.5 * mb.sum(-1) * vecchia._LOG2PI - torch.sum(torch.log(diag) * mb, dim=-1)
            - 0.5 * torch.sum(v * v, dim=-1))


# (bs, m): P = 24, 32, 33 (below, at, one above the 32-column panel), 70 and
# 101 (three and four panels, not multiples of 32), and m = 4.
@pytest.mark.parametrize("nu", [0.5, 3.5])
@pytest.mark.parametrize("bs,m", [(14, 10), (22, 10), (23, 10), (40, 30), (29, 4), (71, 30)])
def test_tiled_loglik_matches_pallas(bs, m, nu):
    ref_p, p, arrs = _case(bs, m)
    bx, by, bm, nx, ny, nm = (jnp.asarray(a) for a in arrs)
    want = sbv_loglik_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget, bx, by,
                             bm.astype(by.dtype), nx, ny, nm.astype(ny.dtype), nu=nu)
    got = _tiled_loglik(p, arrs, nu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def _holes(rng, shape, keep: float, n_min: int = 1):
    """A float mask with random holes, at least ``n_min`` real points a row."""
    msk = rng.uniform(size=shape) < keep
    msk[..., :n_min] = True
    return msk.astype(np.float64)


def _predict_case(bs, m, bc=5, d=3, seed=0):
    """Random prediction blocks with holes in both masks; block 1 has all
    its queries masked, block 2 no real neighbour."""
    rng = np.random.default_rng(seed)
    q_x, nn_x = rng.uniform(size=(bc, bs, d)), rng.uniform(size=(bc, m, d))
    nn_y = rng.normal(size=(bc, m))
    q_m, nn_m = _holes(rng, (bc, bs), 0.8), _holes(rng, (bc, m), 0.8)
    q_m[1], nn_m[2] = 0.0, 0.0
    return q_x, q_m, nn_x, nn_y, nn_m


def _multi_case(bs, m, p=3, bc=5, d=3, seed=0):
    """Random joint blocks with p outputs and holes in both masks; block 1
    has no real block point, block 2 no real neighbour."""
    rng = np.random.default_rng(seed)
    blk_x, nn_x = rng.uniform(size=(bc, bs, d)), rng.uniform(size=(bc, m, d))
    blk_y, nn_y = rng.normal(size=(bc, bs, p)), rng.normal(size=(bc, m, p))
    blk_m, nn_m = _holes(rng, (bc, bs), 0.8), _holes(rng, (bc, m), 0.8)
    blk_m[1], nn_m[2] = 0.0, 0.0
    return blk_x, blk_y, blk_m, nn_x, nn_y, nn_m


def _compact_cov(p, x, nu):
    x = torch.as_tensor(x)
    real = torch.ones(x.shape[0], dtype=torch.bool)
    return vecchia._masked_cov(x, x, real, real, p.beta, p.sigma2, p.nugget, nu, identity=True)


def _tiled_predict(p, arrs, nu):
    """The predict kernel's elimination in plain torch: per block, the masked
    points dropped on the host, the joint matrix [real neighbours; real
    queries] with y_NN as an extra row factored by ``tiled_cholesky_`` over
    its m_real columns; then mu = A^T z and var = prior - colsum(A * A),
    and mu = 0, var = max(prior, 1e-12) at a masked query."""
    q_x, q_m, nn_x, nn_y, nn_m = arrs
    prior = float(p.sigma2 + p.nugget)
    mu = np.zeros(q_m.shape)
    var = np.full(q_m.shape, max(prior, 1e-12))
    for b in range(q_m.shape[0]):
        rn, rq = np.flatnonzero(nn_m[b]), np.flatnonzero(q_m[b])
        mr, pc = len(rn), len(rn) + len(rq)
        if mr == 0:
            continue
        k = _compact_cov(p, np.concatenate([nn_x[b, rn], q_x[b, rq]]), nu)
        at = torch.cat([k[:mr], torch.as_tensor(nn_y[b, rn])[:, None]], dim=-1)
        vecchia.tiled_cholesky_(at, mr, torch.tensor(1e-30, dtype=F64))
        a, z = at[:, mr:pc], at[:, pc]
        mu[b, rq] = (a * z[:, None]).sum(0).numpy()
        var[b, rq] = np.maximum(prior - (a * a).sum(0).numpy(), 1e-12)
    return mu, var


def _tiled_multi_stats(p, arrs, nu):
    """The multi-stats kernel's elimination in plain torch: per block, the
    masked points dropped on the host, the joint matrix of the real points
    with the p observation columns as p extra rows factored by
    ``tiled_cholesky_``; the row [logdet0, q_1 .. q_p] from the block rows."""
    blk_x, blk_y, blk_m, nn_x, nn_y, nn_m = arrs
    out = np.zeros((blk_m.shape[0], 1 + blk_y.shape[2]))
    for b in range(blk_m.shape[0]):
        rn, rb = np.flatnonzero(nn_m[b]), np.flatnonzero(blk_m[b])
        mr, pc = len(rn), len(rn) + len(rb)
        if pc == mr:
            continue
        k = _compact_cov(p, np.concatenate([nn_x[b, rn], blk_x[b, rb]]), nu)
        y = torch.as_tensor(np.concatenate([nn_y[b, rn], blk_y[b, rb]]))
        at = vecchia.tiled_cholesky_(torch.cat([k, y], dim=-1), pc,
                                     torch.tensor(1e-30, dtype=F64))
        diag = torch.diagonal(at)[mr:]
        out[b, 0] = 2.0 * float(torch.log(torch.clamp(diag, min=1e-30)).sum())
        out[b, 1:] = (at[mr:, pc:] ** 2).sum(0).numpy()
    return out


# (bs, m): P = m + bs below, at and above the 32-column panel (m_real below
# one panel too), several panels, and m = 4 (the round-0 small bucket).
@pytest.mark.parametrize("nu", [0.5, 3.5])
@pytest.mark.parametrize("bs,m", [(6, 20), (8, 24), (10, 30), (25, 70), (7, 4)])
def test_tiled_predict_matches_pallas(bs, m, nu):
    ref_p, p, _ = _case(bs, m)
    arrs = _predict_case(bs, m, seed=bs + m)
    want = sbv_predict_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget,
                              *(jnp.asarray(a) for a in arrs), nu=nu)
    got = _tiled_predict(p, arrs, nu)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10 * np.abs(w).max())
    assert np.all(got[0][1] == 0.0) and np.all(got[0][2] == 0.0)  # masked / no neighbour


@pytest.mark.parametrize("nu", [0.5, 3.5])
@pytest.mark.parametrize("bs,m", [(14, 10), (22, 10), (23, 10), (40, 30), (29, 4)])
def test_tiled_multi_stats_matches_pallas(bs, m, nu):
    # The unit-variance correlation: sigma2 = 1, nugget = tau2.
    ref_p = RefParams.create(sigma2=1.0, beta=np.linspace(0.3, 2.0, 3), nugget=1e-2)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    arrs = _multi_case(bs, m, seed=bs + m)
    want = np.asarray(sbv_multi_stats_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget,
                                             *(jnp.asarray(a) for a in arrs), nu=nu))
    got = _tiled_multi_stats(p, arrs, nu)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert np.all(want[1] == 0.0)  # no real block point: [0, 0, .., 0]


def _narrow_case():
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.uniform(size=(2, 20, 3))).bfloat16()
    x1 = torch.as_tensor(rng.uniform(size=(2, 30, 3))).bfloat16()
    y0 = torch.as_tensor(rng.normal(size=(2, 20, 2))).float()
    y1 = torch.as_tensor(rng.normal(size=(2, 30, 2))).float()
    m0, m1 = torch.ones(2, 20, dtype=torch.bool), torch.ones(2, 30, dtype=torch.bool)
    par = tuple(torch.tensor(v, dtype=torch.float32) for v in ([0.4, 0.7, 1.1], 0.5, 1e-2))
    return par, x0, m0, y0, x1, m1, y1


@pytest.mark.parametrize("kernel", ["sbv_loglik", "sbv_multi_stats", "sbv_predict"])
def test_bf16_tier_plain_versions_follow_their_kernels_order(kernel):
    """Each bf16 plain version factors in its kernel's order: the joint
    matrix factored by ``tiled_cholesky_`` (32-column left-looking panels)
    gives its values bitwise, and a factor in another order (LAPACK's, on
    the same f32 matrix) gives other roundings of the same numbers."""
    par, x0, m0, y0, x1, m1, y1 = _narrow_case()
    k = vecchia.narrow_joint(*par, x0, m0, x1, m1, 3.5)
    floor = par[1] * vecchia.BF16_EPS
    if kernel == "sbv_predict":
        got = torch.stack(predict.block_predict_narrow(*par, x1, m1, x0, y0[..., 0], m0))
        prior = par[1] + par[2]
        y = torch.cat([y0[..., :1], torch.zeros(2, 30, 1)], dim=-2)
        at = vecchia.tiled_cholesky_(torch.cat([k, y], dim=-1)[:, :20], 20, floor)
        a, z = at[..., 20:50], at[..., 50]
        want = torch.stack(((a * z[..., None]).sum(-2) * m1.float(),
                            torch.clamp(prior - (a * a).sum(-2), min=1e-12)))
        l_ref = torch.linalg.cholesky(k[:, :20, :20])
        sol = torch.linalg.solve_triangular(l_ref, torch.cat([k[:, :20, 20:], y[:, :20]], -1),
                                            upper=False)
        a, z = sol[..., :30], sol[..., 30]
        other = torch.stack(((a * z[..., None]).sum(-2),
                             torch.clamp(prior - (a * a).sum(-2), min=1e-12)))
    else:
        y = torch.cat([y0, y1], dim=-2)
        y = y if kernel == "sbv_multi_stats" else y[..., :1]
        at = vecchia.tiled_cholesky_(torch.cat([k, y], dim=-1), 50, floor)
        diag = torch.diagonal(at, dim1=-2, dim2=-1)[..., 20:]
        logdet = 2.0 * torch.log(diag.clamp(min=1e-30)).sum(-1)
        v = at[..., 20:, 50:]
        l_ref = torch.linalg.cholesky(k)
        v_ref = torch.linalg.solve_triangular(l_ref, y, upper=False)[..., 20:, :]
        logdet_ref = 2.0 * torch.log(torch.diagonal(l_ref, dim1=-2, dim2=-1)[..., 20:]).sum(-1)
        if kernel == "sbv_multi_stats":
            ld, q = multioutput.block_multi_stats_narrow(*par, x1, y1, m1, x0, y0, m0)
            got = torch.cat([ld[:, None], q], dim=1)
            want = torch.cat([logdet[:, None], (v * v).sum(-2)], dim=1)
            other = torch.cat([logdet_ref[:, None], (v_ref * v_ref).sum(-2)], dim=1)
        else:
            got = vecchia.block_loglik_narrow(*par, x1, y1[..., 0], m1, x0, y0[..., 0], m0)
            want = (-0.5 * 30 * vecchia._LOG2PI - 0.5 * logdet
                    - 0.5 * (v[..., 0] * v[..., 0]).sum(-1)).float()
            other = (-0.5 * 30 * vecchia._LOG2PI - 0.5 * logdet_ref
                     - 0.5 * (v_ref[..., 0] ** 2).sum(-1)).float()
    assert torch.equal(got, want)
    assert not torch.equal(got, other)  # another order, other roundings
    torch.testing.assert_close(got, other, rtol=1e-3, atol=1e-3)


def test_flash_route_by_dtype_and_head_dim():
    """bf16 at hd 64, 80, 128 and 256 takes a wgmma kernel, at 32 the
    mma.sync one; f32 always the scalar one."""
    want = {32: "mma", 64: "wgmma", 80: "wgmma", 128: "wgmma", 256: "wgmma"}
    assert {hd: flash_route(torch.bfloat16, hd) for hd in HEAD_DIMS} == want
    assert {flash_route(torch.float32, hd) for hd in HEAD_DIMS} == {"scalar_f32"}
    with pytest.raises(ValueError, match="head_dim"):
        flash_route(torch.bfloat16, 48)
    with pytest.raises(TypeError):
        flash_route(torch.float16, 64)
