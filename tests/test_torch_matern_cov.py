"""Port vs reference: the batched Matérn covariance kernel's plain version.

On the CPU the port's wrapper runs the plain version, the counterpart of
``repro.kernels.ref.matern_cov_ref``; the reference's Pallas kernel
(``ops.matern_cov``) runs in interpret mode. Shapes are those of
tests/test_kernels_pallas.py (ragged tiles included); f64 at 1e-12, f32 at
that file's 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.kernels_math import KernelParams as RefParams  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.ref import matern_cov_ref  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.matern_cov import (matern_cov_blocks, matern_cov_cuda,  # noqa: E402
                                            matern_cov_plain)


def _case(b, na, nb, d, seed=1):
    rng = np.random.default_rng(seed)
    xa, xb = rng.uniform(size=(b, na, d)), rng.uniform(size=(b, nb, d))
    ref_p = RefParams.create(sigma2=0.7, beta=np.linspace(0.5, 1.5, d))
    return xa, xb, ref_p, params_from_reference(*(np.asarray(a) for a in ref_p))


@pytest.mark.parametrize("b,na,nb,d,tile", [
    (1, 16, 16, 2, 8),
    (3, 50, 70, 4, 32),   # non-divisible -> the reference's padding path
    (2, 128, 128, 8, 128),
    (1, 200, 33, 10, 64),
])
def test_matern_cov_matches_ref_and_pallas(b, na, nb, d, tile):
    xa, xb, ref_p, p = _case(b, na, nb, d)
    got = ops.matern_cov(torch.as_tensor(xa), torch.as_tensor(xb), p).numpy()
    assert got.shape == (b, na, nb)
    want = np.asarray(matern_cov_ref(jnp.asarray(xa), jnp.asarray(xb), ref_p.beta, ref_p.sigma2))
    pallas = np.asarray(ref_ops.matern_cov(jnp.asarray(xa), jnp.asarray(xb), ref_p, tile=tile))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got, pallas, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_matern_cov_every_nu(nu):
    xa, xb, ref_p, p = _case(2, 30, 20, 3, seed=2)
    got = matern_cov_blocks(torch.as_tensor(xa), torch.as_tensor(xb), p.beta, p.sigma2, nu=nu)
    want = matern_cov_ref(jnp.asarray(xa), jnp.asarray(xb), ref_p.beta, ref_p.sigma2, nu=nu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_matern_cov_dtype_sweep():
    rng = np.random.default_rng(2)
    ref_p = RefParams.create(sigma2=1.0, beta=[0.5, 1.0])
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    x = rng.uniform(size=(2, 20, 2))
    for jdt, tdt, tol in [(jnp.float32, torch.float32, 1e-5), (jnp.float64, torch.float64, 1e-12)]:
        xa = torch.as_tensor(x).to(tdt)
        got = ops.matern_cov(xa, xa, p)
        assert got.dtype == tdt
        want = matern_cov_ref(jnp.asarray(x, jdt), jnp.asarray(x, jdt), ref_p.beta.astype(jdt),
                              ref_p.sigma2.astype(jdt))
        np.testing.assert_allclose(got.double().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_matern_cov_refuses_bf16_and_cpu_kernel_launch():
    """bf16 coordinates run only as a pair (the bf16 variant): a bf16 set
    beside a wider one, or half precision, is refused with TypeError, as
    the kernel converts no operand; CPU tensors never launch."""
    x = torch.zeros(1, 4, 2, dtype=torch.float64)
    beta, s2 = torch.ones(2, dtype=torch.float64), torch.ones((), dtype=torch.float64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError, match="xb has dtype torch.float64"):
        matern_cov_cuda(x.to(torch.bfloat16), x, beta, s2)
    with pytest.raises(TypeError, match="float16"):
        matern_cov_cuda(x.half(), x.half(), beta, s2)
    assert matern_cov_plain(x.to(torch.bfloat16), x.to(torch.bfloat16), beta, s2).dtype \
        == torch.float32
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        matern_cov_cuda(x, x, beta, s2)
    assert _build.LAUNCHES == before
