"""Port vs reference: the likelihood kernel's tiled elimination order, on the CPU.

``vecchia.tiled_cholesky_`` is the plain mirror of the likelihood kernel's
factorization core (``tiled_cholesky`` in src/repro_torch/csrc/sbv_common.cuh:
left-looking panels of 32 columns, the diagonal tile factored column by
column with every pivot clamped at the floor, the rows below it solved
against it with its inverse diagonal). It is held to the reference on the
same numpy inputs:

* the factor, and the forward solve of the extra rows, against the Pallas
  body's ``_cholesky_inplace`` / ``_forward_sub`` through JAX, in f64 at
  1e-10 of the factor's scale, with the pivot floor at 1e-30 and with a floor
  that clamps pivots (the bf16 tier's ``2^-7 * sigma2`` against a matrix
  whose small pivots lie far below it, so both orders clamp the same ones);
* the block log-likelihood through the tiled elimination of the joint
  matrix (the observations as an extra row) against ``sbv_loglik_pallas`` in
  interpret mode, in f64 at 1e-10;

at P = m + bs below, at and one above the panel width, across several
panels, and with m = 4 (the round-0 bucket's neighbour count). The bf16
tier's plain version (``block_loglik_narrow``) runs this order; it is held
to the reference's interpret-mode kernel in test_torch_precision.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.kernels.sbv_loglik import _cholesky_inplace, _forward_sub, sbv_loglik_pallas  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import vecchia  # noqa: E402
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


def test_bf16_tier_plain_versions_follow_their_kernels_order():
    """The likelihood's bf16 plain version factors in the tiled kernel's
    order; prediction and the multi-output stats keep the 16-column
    right-looking order of their kernels."""
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.uniform(size=(2, 20, 3))).bfloat16()
    x1 = torch.as_tensor(rng.uniform(size=(2, 30, 3))).bfloat16()
    y0 = torch.as_tensor(rng.normal(size=(2, 20, 1))).float()
    y1 = torch.as_tensor(rng.normal(size=(2, 30, 1))).float()
    m0, m1 = torch.ones(2, 20, dtype=torch.bool), torch.ones(2, 30, dtype=torch.bool)
    par = tuple(torch.tensor(v, dtype=torch.float32) for v in ([0.4, 0.7, 1.1], 0.5, 1e-2))
    tiled = vecchia.narrow_factor(*par, x0, m0, y0, x1, m1, y1, 3.5,
                                  factor=vecchia.tiled_cholesky_)
    ll = vecchia.block_loglik_narrow(*par, x1, y1[..., 0], m1, x0, y0[..., 0], m0)
    diag = torch.diagonal(tiled, dim1=-2, dim2=-1)[..., 20:]
    v = tiled[..., 20:, 50]
    want = (-0.5 * 30 * vecchia._LOG2PI - torch.sum(torch.log(diag.clamp(min=1e-30)), -1)
            - 0.5 * torch.sum(v * v, -1))
    assert torch.equal(ll, want.float())
    panel = vecchia.narrow_factor(*par, x0, m0, y0, x1, m1, y1, 3.5)
    lower = torch.ones(50, 51, dtype=torch.bool).tril(diagonal=-1).logical_not()  # i >= j
    assert not torch.equal(panel[:, lower], tiled[:, lower])  # another order, other roundings
    torch.testing.assert_close(panel[:, lower], tiled[:, lower], rtol=1e-3, atol=1e-3)


def test_flash_route_by_dtype_and_head_dim():
    """bf16 at hd 64 and 128 takes the wgmma kernel, at 32 and 80 the
    mma.sync one, at 256 the scalar one; f32 always the scalar one."""
    want = {32: "mma", 64: "wgmma", 80: "mma", 128: "wgmma", 256: "scalar_bf16"}
    assert {hd: flash_route(torch.bfloat16, hd) for hd in HEAD_DIMS} == want
    assert {flash_route(torch.float32, hd) for hd in HEAD_DIMS} == {"scalar_f32"}
    with pytest.raises(ValueError, match="head_dim"):
        flash_route(torch.bfloat16, 48)
    with pytest.raises(TypeError):
        flash_route(torch.float16, 64)
