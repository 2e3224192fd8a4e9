"""Port vs reference: the in-core slice end to end on the CPU (f64).

Fit: identical structure passes give identical packed arrays, so the two
Adam trajectories are directly comparable. The first loss agrees to
rtol 1e-10; later ones to rtol 1e-6, because the reference takes each Adam
update in float32 and XLA and torch may round it one ulp apart.
Predict: mean/var to 1e-10; with the reference's simulation draws injected,
the simulation statistics to 1e-10 as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import exact_gp as ref_exact  # noqa: E402
from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.predict import predict_sbv as ref_predict_sbv  # noqa: E402
from repro.data import gp_sim as ref_sim  # noqa: E402
from repro_torch.convert import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.core import SBVConfig  # noqa: E402
from repro_torch.core import exact_gp  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.core.predict import predict_sbv  # noqa: E402
from repro_torch.data import gp_sim  # noqa: E402


def _data(n=600, n_test=80, d=4, seed=0):
    x, y, ref_p = ref_sim.paper_synthetic(seed=seed, n=n + n_test, d=d)
    return x[:n], y[:n], x[n:], y[n:], ref_p


def _leaves(p):
    return [np.asarray(a) for a in p]


def test_fit_trajectory_matches_reference():
    x, y, _, _, _ = _data()
    init = RefParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=x.shape[1])
    want = ref_fit(x, y, RefConfig(n_blocks=30, m=16, seed=0), init=init, lr=0.05,
                   inner_steps=5, outer_rounds=2, backend="ref")
    got = fit_sbv(x, y, SBVConfig(n_blocks=30, m=16, seed=0),
                  init=params_from_reference(*_leaves(init)), lr=0.05, inner_steps=5,
                  outer_rounds=2, device="cpu")
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    np.testing.assert_allclose(got.history[0][2], want.history[0][2], rtol=1e-10)
    np.testing.assert_allclose([h[2] for h in got.history], [h[2] for h in want.history],
                               rtol=1e-6)
    for a, b in zip(params_to_reference(got.params), _leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for f in ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask"):
        np.testing.assert_array_equal(getattr(got.packed, f), getattr(want.packed, f))


def _ref_eps(seed):
    def eps(ci, bi, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        return np.asarray(jax.random.normal(key, shape, dtype=jnp.float64))
    return eps


@pytest.mark.parametrize("chunk_size", [None, 32])
def test_predict_matches_reference(chunk_size):
    x, y, xt, _, ref_p = _data(seed=1)
    p = params_from_reference(*_leaves(ref_p))
    kw = dict(bs_pred=5, m_pred=24, n_sims=200, seed=3, chunk_size=chunk_size)
    want = ref_predict_sbv(ref_p, x, y, xt, **kw)
    got = predict_sbv(p, x, y, xt, device="cpu", eps=_ref_eps(3), **kw)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-10, atol=1e-10,
                                   err_msg=f)
    # Without injected draws the port's own generator gives the same mean/var.
    own = predict_sbv(p, x, y, xt, device="cpu", **kw)
    np.testing.assert_array_equal(own.mean, got.mean)
    np.testing.assert_array_equal(own.var, got.var)
    assert np.all(own.ci_low < own.ci_high)


def test_predict_all_neighbours_matches_exact_gp():
    rng = np.random.default_rng(5)
    x, xt = rng.uniform(size=(60, 3)), rng.uniform(size=(25, 3))
    y = rng.normal(size=60)
    p = params_from_reference(*_leaves(RefParams.create(sigma2=1.1, beta=[0.5, 0.8, 1.2],
                                                        nugget=1e-2)))
    pred = predict_sbv(p, x, y, xt, bs_pred=5, m_pred=80, n_sims=10, device="cpu")
    em, ev = exact_gp.exact_predict(p, torch.as_tensor(x), torch.as_tensor(y),
                                    torch.as_tensor(xt), device="cpu")
    np.testing.assert_allclose(pred.mean, em.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pred.var, ev.numpy(), rtol=0, atol=1e-12)


def test_exact_gp_matches_reference():
    rng = np.random.default_rng(6)
    x, xt = rng.uniform(size=(40, 3)), rng.uniform(size=(9, 3))
    y = rng.normal(size=40)
    ref_p = RefParams.create(sigma2=0.9, beta=[0.3, 0.7, 2.0], nugget=1e-3)
    p = params_from_reference(*_leaves(ref_p))
    tx, ty, txt = (torch.as_tensor(a) for a in (x, y, xt))
    np.testing.assert_allclose(float(exact_gp.exact_loglik(p, tx, ty, device="cpu")),
                               float(ref_exact.exact_loglik(ref_p, jnp.asarray(x),
                                                            jnp.asarray(y))), rtol=1e-10)
    for a, b in zip(exact_gp.exact_predict(p, tx, ty, txt, device="cpu"),
                    ref_exact.exact_predict(ref_p, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(xt))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


def test_generators_match_reference():
    for (gx, gy), (rx, ry) in zip(gp_sim.paper_synthetic_chunks(7, 900, gen_rows=400,
                                                                n_features=256),
                                  ref_sim.paper_synthetic_chunks(7, 900, gen_rows=400,
                                                                 n_features=256)):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    gx, gy, gp = gp_sim.paper_synthetic(seed=8, n=3500, d=3)
    rx, ry, rp = ref_sim.paper_synthetic(seed=8, n=3500, d=3)  # RFF branch
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_allclose(gy, ry, rtol=1e-12, atol=1e-13)
    x = np.random.default_rng(9).uniform(size=(50, 3))
    ex = gp_sim.sample_gp_exact(1, x, gp)
    np.testing.assert_allclose(ex, ref_sim.sample_gp_exact(1, x, rp), rtol=1e-8, atol=1e-10)
