"""Port vs reference: the block likelihood, its gradient and the kernel wrapper.

On the CPU the port's wrapper runs the kernel's plain version; the
reference's Pallas kernel runs in interpret mode, as in
tests/test_kernels_pallas.py. Tolerances are that file's: values rtol 1e-9,
gradients rtol 1e-8, f32 within 5e-4 of f64.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core import vecchia as ref_vecchia  # noqa: E402
from repro.kernels.sbv_loglik import sbv_loglik_pallas  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import vecchia  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sbv_loglik import sbv_loglik_blocks, sbv_loglik_cuda  # noqa: E402


def _case(n=40, d=3, bc=8, m=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = rng.normal(size=n)
    beta = np.linspace(0.3, 2.0, d)
    packed, _ = ref_preprocess(x, y, beta, RefConfig(n_blocks=bc, m=m, seed=seed))
    ref_p = RefParams.create(sigma2=1.4, beta=beta, nugget=1e-2)
    p = params_from_reference(*(np.asarray(a) for a in ref_p))
    return ref_p, p, packed


def _ref_arrays(packed):
    return tuple(jnp.asarray(a) for a in (packed.blk_x, packed.blk_y, packed.blk_mask,
                                          packed.nn_x, packed.nn_y, packed.nn_mask))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_packed_loglik_matches_pallas_and_ref(nu):
    ref_p, p, packed = _case()
    got = float(vecchia.packed_loglik(p, packed, nu=nu))
    bx, by, bm, nx, ny, nm = _ref_arrays(packed)
    pallas = sbv_loglik_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget, bx, by,
                               bm.astype(by.dtype), nx, ny, nm.astype(ny.dtype), nu=nu)
    ref = ref_vecchia.batched_block_loglik(ref_p, bx, by, bm, nx, ny, nm, nu=nu)
    np.testing.assert_allclose(got, float(jnp.sum(pallas)), rtol=1e-9)
    np.testing.assert_allclose(got, float(ref), rtol=1e-9)
    np.testing.assert_allclose(float(vecchia.packed_loglik(p, packed, nu=nu, backend="ref")),
                               float(ref), rtol=1e-9)


@pytest.mark.parametrize("n,d,bc,m", [(40, 2, 8, 6), (50, 4, 8, 12), (30, 3, 2, 24)])
def test_per_block_plain_matches_pallas_shapes(n, d, bc, m):
    ref_p, p, packed = _case(n, d, bc, m, seed=1)
    bx, by, bm, nx, ny, nm = _ref_arrays(packed)
    want = sbv_loglik_pallas(ref_p.beta, ref_p.sigma2, ref_p.nugget, bx, by,
                             bm.astype(by.dtype), nx, ny, nm.astype(ny.dtype))
    arrs = vecchia.packed_arrays(packed, "cpu")
    got = sbv_loglik_blocks(p.beta, p.sigma2, p.nugget, *arrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_gradient_matches_jax_grad():
    ref_p, p, packed = _case(seed=2)
    arrs = vecchia.packed_arrays(packed, "cpu")
    leaves = [t.clone().requires_grad_(True) for t in p]
    by = arrs[1].clone().requires_grad_(True)
    ll = ops.sbv_loglik(type(p)(*leaves), arrs[0], by, *arrs[2:])
    got = torch.autograd.grad(ll, leaves + [by])
    g_ref = jax.grad(lambda q: ref_vecchia.packed_loglik(q, packed, backend="ref"))(ref_p)
    for a, b in zip(got[:3], g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8)
    bx, jby, bm, nx, ny, nm = _ref_arrays(packed)
    g_by = jax.grad(lambda v: ref_vecchia.batched_block_loglik(ref_p, bx, v, bm, nx, ny, nm))(jby)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(g_by), rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_backward_equals_unchunked(chunk):
    _, p, packed = _case(seed=3)
    arrs = vecchia.packed_arrays(packed, "cpu")

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in p]
        ny = arrs[4].clone().requires_grad_(True)
        ll = fn(type(p)(*leaves), ny)
        return [g.numpy() for g in torch.autograd.grad(ll, leaves + [ny])]

    chunked = grads(lambda q, ny: ops.sbv_loglik(q, *arrs[:4], ny, arrs[5], chunk=chunk))
    whole = grads(lambda q, ny: ops.sbv_loglik(q, *arrs[:4], ny, arrs[5],
                                               chunk=packed.n_blocks))
    plain = grads(lambda q, ny: vecchia.batched_block_loglik(q, *arrs[:4], ny, arrs[5]))
    for a, b, c in zip(chunked, whole, plain):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-15)


def test_non_pd_block_gives_nan_like_reference():
    ref_p, p, packed = _case(seed=4)
    arrs = vecchia.packed_arrays(packed, "cpu")
    # A negative nugget makes every block's covariance indefinite.
    got = vecchia.block_loglik(p.beta, p.sigma2, torch.tensor(-5.0, dtype=torch.float64), *arrs)
    ns = types.SimpleNamespace(beta=ref_p.beta, sigma2=ref_p.sigma2, nugget=jnp.asarray(-5.0))
    want = ref_vecchia._block_loglik_one(ns, 3.5, *(a[1] for a in _ref_arrays(packed)))
    assert np.isnan(float(want))
    assert torch.isnan(got).all()
    assert torch.isfinite(vecchia.block_loglik(p.beta, p.sigma2, p.nugget, *arrs)).all()


def test_f32_within_5e4_of_f64():
    _, p, packed = _case(seed=5)
    f64 = float(vecchia.packed_loglik(p, packed))
    arrs32 = tuple(a.float() if a.is_floating_point() else a
                   for a in vecchia.packed_arrays(packed, "cpu"))
    f32 = vecchia.packed_loglik(p, packed, arrays=arrs32)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(float(f32), f64, rtol=5e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, p, packed = _case(seed=6)
    arrs = vecchia.packed_arrays(packed, "cpu")
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sbv_loglik_cuda(p.beta, p.sigma2, p.nugget, *arrs)
