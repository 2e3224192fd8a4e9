"""Port vs reference: Matérn kernels and covariance matrices (f64, CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as ref_km  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import kernels_math as km  # noqa: E402

NUS = [0.5, 1.5, 2.5, 3.5]


@pytest.mark.parametrize("nu", NUS)
def test_matern_matches_reference_and_scipy(nu):
    r = np.concatenate([[0.0], np.random.default_rng(0).uniform(1e-3, 8.0, 200)])
    got = km.matern(torch.as_tensor(r), nu).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_km.matern(jnp.asarray(r), nu)), rtol=1e-12)
    np.testing.assert_allclose(got, km.matern_scipy_oracle(r, nu), rtol=1e-12)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("add_nugget", [False, True])
def test_cov_matrix_matches_reference(nu, add_nugget):
    rng = np.random.default_rng(1)
    d = 4
    x1 = rng.uniform(size=(7, d))
    x2 = x1 if add_nugget else rng.uniform(size=(5, d))
    ref_p = ref_km.KernelParams.create(sigma2=1.3, beta=np.linspace(0.2, 1.5, d), nugget=1e-2)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    got = km.cov_matrix(torch.as_tensor(x1), torch.as_tensor(x2), p, nu=nu,
                        add_nugget=add_nugget).numpy()
    want = np.asarray(ref_km.cov_matrix(jnp.asarray(x1), jnp.asarray(x2), ref_p, nu=nu,
                                        add_nugget=add_nugget))
    if not add_nugget:
        np.testing.assert_allclose(got, want, rtol=1e-12)
        return
    off = ~np.eye(got.shape[0], dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-12)
    # On the diagonal both packages take the distance of a point to itself
    # in the norm form |z|^2 + |z|^2 - 2 z.z, which rounds to ~1e-16, not 0,
    # and each rounds it differently. sqrt lifts that to r ~ 1e-8; the
    # nu = 0.5 kernel exp(-r) is not flat at 0 and passes it on, the
    # smoother kernels (1 - O(r^2)) do not.
    diag_rtol = 1e-7 if nu == 0.5 else 1e-12
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=diag_rtol)


def test_params_round_trip_and_properties():
    ref_p = ref_km.KernelParams.create(sigma2=2.0, beta=[0.5, 3.0], nugget=1e-4)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    np.testing.assert_allclose(p.beta.numpy(), [0.5, 3.0], rtol=1e-15)
    np.testing.assert_allclose(float(p.sigma2), 2.0, rtol=1e-15)
    np.testing.assert_allclose(float(p.nugget), 1e-4, rtol=1e-15)
    from repro_torch.convert import params_to_reference

    for a, b in zip(params_to_reference(p), ref_p):
        np.testing.assert_array_equal(a, np.asarray(b))
    c = km.KernelParams.create(sigma2=2.0, beta=0.5, nugget=1e-4, d=3)
    assert c.log_beta.shape == (3,) and c.log_beta.dtype == torch.float64


@pytest.mark.parametrize("nu", [0.5, 3.5])
def test_self_distance_is_exact_in_the_plain_covariance(nu):
    """ROADMAP fault 1: with ``identity`` a point's distance to itself is
    exactly 0 (as in the CUDA kernels), the diagonal is exactly
    sigma2 + nugget, gradients stay finite, and the port still agrees with
    the reference, whose diagonal keeps its own rounding (1e-7 at nu = 0.5,
    as above)."""
    from repro.core import vecchia as ref_vecchia
    from repro_torch.core import vecchia

    rng = np.random.default_rng(3)
    x = rng.uniform(size=(2, 9, 4))
    mask = np.ones((2, 9), dtype=bool)
    mask[1, 6:] = False
    ref_p = ref_km.KernelParams.create(sigma2=1.3, beta=np.linspace(0.2, 1.5, 4), nugget=1e-2)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    leaves = [t.clone().requires_grad_(True) for t in p]
    q = km.KernelParams(*leaves)
    tx, tm = torch.as_tensor(x), torch.as_tensor(mask)
    k = vecchia._masked_cov(tx, tx, tm, tm, q.beta, q.sigma2, q.nugget, nu, identity=True)
    diag = torch.diagonal(k, dim1=-2, dim2=-1).detach()
    want_diag = torch.where(tm, p.sigma2 + p.nugget, torch.ones((), dtype=torch.float64))
    assert torch.equal(diag, want_diag)
    grads = torch.autograd.grad(torch.linalg.cholesky(k).diagonal(dim1=-2, dim2=-1).log().sum(),
                                leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for b in range(2):
        want = np.asarray(ref_vecchia._masked_cov(jnp.asarray(x[b]), jnp.asarray(x[b]),
                                                  jnp.asarray(mask[b]), jnp.asarray(mask[b]),
                                                  ref_p, nu, identity=True))
        got = k[b].detach().numpy()
        off = ~np.eye(9, dtype=bool)
        np.testing.assert_allclose(got[off], want[off], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=1e-7 if nu == 0.5 else 1e-12)
