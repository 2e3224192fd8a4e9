"""Port vs reference: block prediction and the predict-kernel wrapper.

The reference runs its Pallas kernel in interpret mode; the port's wrapper
runs the kernel's plain version on CPU tensors. Tolerance rtol 1e-10 (f64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import predict as ref_predict  # noqa: E402
from repro.kernels.sbv_predict import sbv_predict_pallas  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import predict  # noqa: E402
from repro_torch.core.packing import PackedPrediction  # noqa: E402
from repro_torch.kernels.sbv_predict import sbv_predict_cuda  # noqa: E402


def _case(n=120, n_test=30, d=3, bs=5, m=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = rng.normal(size=n)
    x_test = rng.uniform(size=(n_test, d))
    beta = np.linspace(0.4, 1.8, d)
    idx = ref_predict.build_train_index(x, y, beta, m_pred=m, seed=seed)
    packed = ref_predict.pack_queries(idx, x_test, bs, m, seed=seed)
    ref_p = RefParams.create(sigma2=1.2, beta=beta, nugget=1e-3)
    return ref_p, params_from_reference(*(np.asarray(a) for a in ref_p)), packed


def _tensors(packed, device="cpu"):
    return tuple(torch.as_tensor(a).to(device) for a in packed.arrays())


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_batched_block_predict_matches_pallas_and_ref(nu):
    ref_p, p, packed = _case(seed=1)
    mu, var = predict.batched_block_predict(p, *_tensors(packed), nu=nu)
    q_x, q_m, n_x, n_y, n_m = (jnp.asarray(a) for a in packed.arrays())
    pm, pv = sbv_predict_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget, q_x,
                                q_m.astype(n_y.dtype), n_x, n_y, n_m.astype(n_y.dtype), nu=nu)
    rm, rv = ref_predict.batched_block_predict(ref_p, q_x, q_m, n_x, n_y, n_m, nu=nu,
                                               backend="ref")
    msk = packed.q_mask
    # nu = 0.5: the norm-form distance of a neighbour to itself rounds to
    # ~1e-16 instead of 0, differently in each package; exp(-r) is not flat
    # at r = 0, so K(NN, NN)'s diagonal differs by ~1e-8 and the solve passes
    # ~1e-7 on (see ROADMAP, faults). The smoother kernels are flat there.
    tol = 1e-6 if nu == 0.5 else 1e-10
    for got, want in ((mu, pm), (var, pv), (mu, rm), (var, rv)):
        np.testing.assert_allclose(got.numpy()[msk], np.asarray(want)[msk], rtol=tol,
                                   atol=1e-14)
    rm2, rv2 = predict.batched_block_predict(p, *_tensors(packed), nu=nu, backend="ref")
    np.testing.assert_allclose(rm2.numpy(), mu.numpy(), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(rv2.numpy(), var.numpy(), rtol=1e-12, atol=1e-15)


def _widen(packed: PackedPrediction, bs_extra: int, m_extra: int, bc_extra: int):
    w = lambda a, k: np.concatenate(
        [a, np.zeros(a.shape[:1] + (k,) + a.shape[2:], dtype=a.dtype)], axis=1)
    wide = PackedPrediction(
        q_x=w(packed.q_x, bs_extra), q_mask=w(packed.q_mask, bs_extra),
        q_idx=w(packed.q_idx, bs_extra), nn_x=w(packed.nn_x, m_extra),
        nn_y=w(packed.nn_y, m_extra), nn_mask=w(packed.nn_mask, m_extra),
        owners=packed.owners)
    return wide.pad_to_blocks(packed.n_blocks + bc_extra)


@pytest.mark.parametrize("bs_extra,m_extra,bc_extra", [(5, 0, 0), (0, 7, 0), (5, 7, 3)])
def test_padding_is_inert(bs_extra, m_extra, bc_extra):
    # The setup of the reference's own padding test (tests/test_predict_packed.py).
    from repro.data.gp_sim import paper_synthetic

    x, y, ref_p = paper_synthetic(seed=3, n=200, d=3)
    x, y = x[:60], y[:60]
    xt = np.random.default_rng(4).uniform(size=(40, 3))
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    index = predict.build_train_index(x, y, p.beta.numpy(), 24, seed=3)
    packed = predict.pack_queries(index, xt, bs_pred=8, m_pred=24, seed=3)
    mu, var = predict.batched_block_predict(p, *_tensors(packed))
    wide = _widen(packed, bs_extra, m_extra, bc_extra)
    mu_w, var_w = predict.batched_block_predict(p, *_tensors(wide))
    bc, bs = packed.q_mask.shape
    msk = packed.q_mask
    np.testing.assert_allclose(mu_w.numpy()[:bc, :bs][msk], mu.numpy()[msk], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(var_w.numpy()[:bc, :bs][msk], var.numpy()[msk], rtol=1e-12,
                               atol=1e-12)
    assert torch.isfinite(mu_w).all() and torch.isfinite(var_w).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    _, p, packed = _case(seed=3)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sbv_predict_cuda(p.beta, p.sigma2, p.nugget, *_tensors(packed))
