"""Port vs reference: the exact GP's log-determinant, the KL divergence of
paper Eq. 4, and the prediction error metrics, on the CPU (f64).

The KL is held at the likelihood's rtol 1e-9 on tests/test_vecchia_core.py's
fixture (n = 120, 24 blocks, m in {4, 16, 60}), through both routes: on the
CPU ``backend='auto'`` runs the kernels' plain versions. The log-determinant
is held at rtol 1e-12 for every nu: on the CPU both packages assemble the
matrix in the same matmul form (measured: within 1.1e-15 of each other).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import exact_gp as ref_exact  # noqa: E402
from repro.core import kl_divergence as ref_kl  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core.predict import mspe as ref_mspe  # noqa: E402
from repro.core.predict import rmspe as ref_rmspe  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import SBVConfig, exact_gp, kl_divergence, preprocess  # noqa: E402
from repro_torch.core.predict import mspe, rmspe  # noqa: E402

# tests/test_vecchia_core.py's parameters and points.
REF_PAR = RefParams.create(sigma2=1.3, beta=[0.3, 0.5, 2.0], nugget=1e-2, d=3)
PAR = params_from_reference(*(np.asarray(a) for a in REF_PAR))


def _points(n=120, d=3, seed=3):
    return np.random.default_rng(seed).uniform(size=(n, d))


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_kl_divergence_matches_reference(backend):
    x = _points()
    y = np.zeros(x.shape[0])
    kls = []
    for m in (4, 16, 60):
        packed, _ = preprocess(x, y, PAR.beta.numpy(), SBVConfig(n_blocks=24, m=m, seed=1))
        ref_packed, _ = ref_preprocess(x, y, REF_PAR.beta, RefConfig(n_blocks=24, m=m, seed=1))
        got = kl_divergence(PAR, x, packed, device="cpu", backend=backend)
        want = ref_kl(REF_PAR, x, ref_packed)
        np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=f"m={m}")
        kls.append(got)
    # As the reference's test holds it: non-negative, and no worse at m = 60.
    assert all(k >= -1e-8 for k in kls), kls
    assert kls[-1] <= kls[0] + 1e-8, kls


def test_kl_divergence_ignores_observations_and_grad():
    """The packed observations do not enter Eq. 4, and parameters that
    require grad are detached (the result is a float)."""
    x = _points(60, seed=4)
    rng = np.random.default_rng(5)
    cfg = SBVConfig(n_blocks=12, m=10, seed=1)
    packed0, _ = preprocess(x, np.zeros(60), PAR.beta.numpy(), cfg)
    packed1, _ = preprocess(x, rng.normal(size=60), PAR.beta.numpy(), cfg)
    leaves = type(PAR)(*(t.clone().requires_grad_(True) for t in PAR))
    assert kl_divergence(leaves, x, packed1, device="cpu") == kl_divergence(PAR, x, packed0,
                                                                           device="cpu")


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, 3.5])
def test_exact_logdet_matches_reference(nu):
    x = _points(80, seed=6)
    got = exact_gp.exact_logdet(PAR, x, nu=nu, device="cpu")
    want = ref_exact.exact_logdet(REF_PAR, jnp.asarray(x), nu=nu)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    # The log-likelihood at y = 0 is -n/2 log(2 pi) - logdet / 2.
    ll0 = exact_gp.exact_loglik(PAR, x, np.zeros(80), nu=nu, device="cpu")
    np.testing.assert_allclose(float(ll0), -40.0 * np.log(2.0 * np.pi) - 0.5 * float(got),
                               rtol=1e-14)


def test_exact_routes_agree_on_cpu():
    """On the CPU both routes assemble with ``cov_matrix``: the same values."""
    rng = np.random.default_rng(7)
    x, y, xt = rng.uniform(size=(50, 3)), rng.normal(size=50), rng.uniform(size=(11, 3))
    for fn, args in ((exact_gp.exact_loglik, (x, y)), (exact_gp.exact_logdet, (x,)),
                     (exact_gp.exact_predict, (x, y, xt))):
        a = fn(PAR, *args, device="cpu", backend="auto")
        b = fn(PAR, *args, device="cpu", backend="ref")
        for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        exact_gp.exact_logdet(PAR, x, device="cpu", backend="pallas")


def test_exact_ref_route_differentiates():
    """``backend='ref'`` keeps the gradient, as the reference's jnp form does."""
    x = _points(30, seed=8)
    leaves = type(PAR)(*(t.clone().requires_grad_(True) for t in PAR))
    ll = exact_gp.exact_loglik(leaves, x, np.ones(30), device="cpu", backend="ref")
    grads = torch.autograd.grad(ll, list(leaves))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("truth_zero", [False, True])
def test_mspe_rmspe_match_reference(truth_zero):
    rng = np.random.default_rng(9)
    pred, truth = rng.normal(size=200), rng.normal(size=200)
    if truth_zero:
        truth[::7] = 0.0  # rmspe divides by 1 where |truth| <= 1e-12
    assert mspe(pred, truth) == ref_mspe(pred, truth)
    assert rmspe(pred, truth) == ref_rmspe(pred, truth)


_EXACT_CALLS = {
    "exact_loglik": lambda p, **kw: exact_gp.exact_loglik(p, _points(10), np.zeros(10), **kw),
    "exact_logdet": lambda p, **kw: exact_gp.exact_logdet(p, _points(10), **kw),
    "exact_predict": lambda p, **kw: exact_gp.exact_predict(p, _points(10), np.zeros(10),
                                                            _points(4, seed=1), **kw),
}


def _kl_call(p, **kw):
    x = _points(40, seed=10)
    packed, _ = preprocess(x, np.zeros(40), PAR.beta.numpy(), SBVConfig(n_blocks=8, m=6, seed=1))
    return kl_divergence(p, x, packed, **kw)


@pytest.mark.parametrize("name", sorted(_EXACT_CALLS) + ["kl_divergence"])
def test_exact_functions_need_a_device(name, monkeypatch):
    """Without a CUDA device the exact functions and Eq. 4 raise unless
    given ``device='cpu'``; they never fall back to the CPU on their own,
    wherever the parameters lie."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _kl_call if name == "kl_divergence" else _EXACT_CALLS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(PAR)
    out = call(PAR, device="cpu")
    if name == "kl_divergence":
        assert isinstance(out, float) and np.isfinite(out)
        return
    assert all(t.device.type == "cpu" for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("name", sorted(_EXACT_CALLS))
def test_exact_kernel_route_refuses_parameters_that_require_grad(name):
    """On a CUDA device the kernel route (``backend='auto'``) cannot carry a
    gradient, so it raises before anything moves to the card, rather than
    drop the gradient; this holds with or without a card present."""
    leaves = type(PAR)(*(t.clone().requires_grad_(True) for t in PAR))
    with pytest.raises(RuntimeError, match="not differentiable"):
        _EXACT_CALLS[name](leaves, device="cuda")
    # On the CPU the same call differentiates.
    _EXACT_CALLS[name](leaves, device="cpu")
