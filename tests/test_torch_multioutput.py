"""Port vs reference: the multi-output (VPPE) slice on the CPU (f64).

The problem is the reference's own fixture (tests/test_multioutput.py:
n 500, d 3, p 3, 16 blocks, m 20), inputs from a numpy seed. On the CPU the
port's kernel wrapper runs the plain version; the reference's Pallas
multi-stats kernel runs in interpret mode. Tolerances: stats rtol 1e-10,
gradients 1e-8 (tests/test_kernels_pallas.py), per-step fit history
rel 1e-8 (the reference's REL), predict rel 1e-10
(tests/test_predict_packed.py); p = 1 is bitwise the single-output path
(docs/multioutput.md).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import multioutput as ref_mo  # noqa: E402
from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.pipeline import SBVConfig as RefConfig  # noqa: E402
from repro.core.pipeline import preprocess as ref_preprocess  # noqa: E402
from repro.core.predict import predict_sbv as ref_predict_sbv  # noqa: E402
from repro.kernels.sbv_loglik import sbv_multi_stats_pallas  # noqa: E402
from repro_torch.convert import (multi_params_from_reference,  # noqa: E402
                                 multi_params_to_reference)
from repro_torch.core import SBVConfig, vecchia  # noqa: E402
from repro_torch.core import multioutput as mo  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.core.predict import predict_sbv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sbv_multi_stats import sbv_multi_stats_blocks  # noqa: E402

PARAM_FIELDS = ("log_sigma2", "log_beta", "log_tau2")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d, p = 500, 3, 3
    x = rng.uniform(size=(n, d))
    y = np.stack([np.sin(x @ rng.uniform(1.0, 3.0, size=d)) + 0.01 * rng.standard_normal(n)
                  for _ in range(p)], axis=1)
    ref_p = ref_mo.MultiOutputParams.create(sigma2=[0.4, 0.7, 1.3], beta=[0.3, 0.5, 0.9],
                                            tau2=1e-3, d=d, p=p)
    packed, _ = ref_preprocess(x, y, np.asarray(ref_p.beta), RefConfig(n_blocks=16, m=20, seed=0))
    return x, y, ref_p, multi_params_from_reference(*_leaves(ref_p)), packed


@pytest.fixture(scope="module")
def ref_fitted(problem):
    x, y, _, _, _ = problem
    return ref_fit(x, y, RefConfig(n_blocks=16, m=20, seed=0), inner_steps=4, outer_rounds=1,
                   backend="ref")


def _leaves(p):
    return [np.asarray(a) for a in p]


def _ref_arrays(packed):
    return tuple(jnp.asarray(a) for a in (packed.blk_x, packed.blk_y, packed.blk_mask,
                                          packed.nn_x, packed.nn_y, packed.nn_mask))


def _ref_eps(seed):
    def eps(ci, bi, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        return np.asarray(jax.random.normal(key, shape, dtype=jnp.float64))
    return eps


@pytest.mark.parametrize("nu", [0.5, 3.5])
def test_block_multi_stats_match_reference_and_pallas(problem, nu):
    _, _, ref_p, p, packed = problem
    p0 = p.structure_params()
    arrs = vecchia.packed_arrays(packed, "cpu")
    ld, q = mo.block_multi_stats(p0.beta, p0.sigma2, p0.nugget, *arrs, nu=nu)
    bx, by, bm, nx, ny, nm = _ref_arrays(packed)
    r0 = ref_p.structure_params()
    ld_r, q_r = ref_mo.batched_multi_stats(r0, bx, by, bm, nx, ny, nm, nu=nu)
    np.testing.assert_allclose(float(ld.sum()), float(ld_r), rtol=1e-10)
    np.testing.assert_allclose(q.sum(dim=0).numpy(), np.asarray(q_r), rtol=1e-10)
    pallas = np.asarray(sbv_multi_stats_pallas(
        r0.beta, r0.sigma2, r0.nugget, bx, by, bm.astype(by.dtype), nx, ny,
        nm.astype(ny.dtype), nu=nu, interpret=True))
    blocks = sbv_multi_stats_blocks(p0.beta, p0.sigma2, p0.nugget, *arrs, nu=nu)
    assert blocks.shape == (packed.n_blocks, 1 + packed.blk_y.shape[2])
    np.testing.assert_allclose(blocks.numpy(), pallas, rtol=1e-10)
    np.testing.assert_allclose(blocks[:, 0].numpy(), ld.numpy(), rtol=1e-15)


def test_pooled_gradient_matches_jax_grad(problem):
    _, _, ref_p, p, packed = problem
    arrs = vecchia.packed_arrays(packed, "cpu")
    n = packed.n_points
    g_ref = jax.grad(ref_mo.multi_profile_neg_loglik_fn(packed, 3.5, "ref"))(ref_p)
    for backend in ("auto", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in p]
        ld, q = mo.packed_multi_stats(mo.MultiOutputParams(*leaves), packed, backend=backend,
                                      arrays=arrs)
        got = torch.autograd.grad(mo.pooled_objective(ld, q, n), leaves, allow_unused=True)
        assert got[0] is None  # log_sigma2 is profiled out of the pooled objective
        np.testing.assert_array_equal(np.asarray(g_ref.log_sigma2), 0.0)
        for f, a in zip(PARAM_FIELDS[1:], got[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(getattr(g_ref, f)), rtol=1e-8,
                                       err_msg=f"{backend} {f}")


def test_chunked_backward_matches_jax_vjp_in_observations(problem):
    """The autograd.Function's chunked backward against the reference's
    VJP, with both cotangents (g_ld, g_q) and the observation gradients."""
    _, _, ref_p, p, packed = problem
    arrs = list(vecchia.packed_arrays(packed, "cpu"))
    g_ld, g_q = 0.7, np.array([1.0, -2.0, 0.5])
    r0 = ref_p.structure_params()
    bx, by, bm, nx, ny, nm = _ref_arrays(packed)

    def combo(pp, yb, yn):
        ld, q = ref_mo.batched_multi_stats(pp, bx, yb, bm, nx, yn, nm)
        return g_ld * ld + jnp.sum(jnp.asarray(g_q) * q)

    want = jax.grad(combo, argnums=(0, 1, 2))(r0, by, ny)
    p0 = p.structure_params()
    leaves = [t.clone().requires_grad_(True) for t in p0]
    yb = arrs[1].clone().requires_grad_(True)
    yn = arrs[4].clone().requires_grad_(True)
    ld, q = ops.sbv_multi_stats(type(p0)(*leaves), arrs[0], yb, arrs[2], arrs[3], yn, arrs[5],
                                chunk=5)
    got = torch.autograd.grad(g_ld * ld + torch.sum(torch.as_tensor(g_q) * q),
                              leaves[1:] + [yb, yn])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0].log_beta), rtol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[0].log_nugget), rtol=1e-8)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[1]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[2]), rtol=1e-8, atol=1e-12)


def test_multi_loglik_and_profiled_sigma2_match_reference(problem):
    _, _, ref_p, p, packed = problem
    np.testing.assert_allclose(mo.multi_loglik(p, packed).numpy(),
                               np.asarray(ref_mo.multi_loglik(ref_p, packed)), rtol=1e-10)
    got = mo.with_profiled_sigma2(p, packed)
    want = ref_mo.with_profiled_sigma2(ref_p, packed)
    for a, b in zip(multi_params_to_reference(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    # The pooled objective at the profiled sigma2 is the mean per-output nll.
    ld, q = mo.packed_multi_stats(got, packed)
    np.testing.assert_allclose(float(mo.pooled_objective(ld, q, packed.n_points)),
                               float(-mo.multi_loglik(got, packed).mean() / packed.n_points),
                               rtol=1e-12)


def test_multi_fit_history_matches_reference(problem, ref_fitted):
    x, y, _, _, _ = problem
    got = fit_sbv(x, y, SBVConfig(n_blocks=16, m=20, seed=0), inner_steps=4, outer_rounds=1,
                  device="cpu")
    assert isinstance(got.params, mo.MultiOutputParams)
    assert [h[:2] for h in got.history] == [h[:2] for h in ref_fitted.history]
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in ref_fitted.history], rtol=1e-8)
    for a, b in zip(multi_params_to_reference(got.params), _leaves(ref_fitted.params)):
        np.testing.assert_allclose(a, b, rtol=1e-8)
    for f in ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask"):
        np.testing.assert_array_equal(getattr(got.packed, f), getattr(ref_fitted.packed, f))


def test_multi_predict_matches_reference(problem, ref_fitted):
    x, y, _, _, _ = problem
    ref_p = ref_fitted.params
    p = multi_params_from_reference(*_leaves(ref_p))
    xq = np.random.default_rng(7).uniform(size=(50, x.shape[1]))
    kw = dict(bs_pred=8, m_pred=24, seed=3, n_sims=40, chunk_size=24)
    want = ref_predict_sbv(ref_p, x, y, xq, **kw)
    got = predict_sbv(p, x, y, xq, device="cpu", eps=_ref_eps(3), **kw)
    assert got.mean.shape == (50, 3)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-10, atol=1e-12,
                                   err_msg=f)
    assert np.all(got.var > 0)
    # A KernelParams is broadcast over the outputs, as in the reference.
    kp = ref_p.output_params(0)
    want_b = ref_predict_sbv(kp, x, y, xq, **kw)
    got_b = predict_sbv(p.output_params(0), x, y, xq, device="cpu", eps=_ref_eps(3), **kw)
    np.testing.assert_allclose(got_b.mean, want_b.mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got_b.var, want_b.var, rtol=1e-10, atol=1e-12)


def test_p1_fit_and_predict_are_bitwise_single_output(problem):
    x, y, _, p, _ = problem
    cfg = SBVConfig(n_blocks=16, m=20, seed=0)
    r1 = fit_sbv(x, y[:, 0], cfg, inner_steps=3, outer_rounds=1, device="cpu")
    r2 = fit_sbv(x, y[:, :1], cfg, inner_steps=3, outer_rounds=1, device="cpu")
    assert r1.history == r2.history
    for a, b in zip(r1.params, r2.params):
        assert torch.equal(a, b)
    # A MultiOutputParams init reduces to its output 0.
    r3 = fit_sbv(x, y[:, :1], cfg, init=p, inner_steps=2, outer_rounds=1, device="cpu")
    r4 = fit_sbv(x, y[:, 0], cfg, init=p.output_params(0), inner_steps=2, outer_rounds=1,
                 device="cpu")
    assert r3.history == r4.history
    xq = np.random.default_rng(5).uniform(size=(40, x.shape[1]))
    kw = dict(bs_pred=8, m_pred=24, seed=0, n_sims=20, device="cpu")
    p1 = predict_sbv(r1.params, x, y[:, 0], xq, **kw)
    p2 = predict_sbv(r1.params, x, y[:, :1], xq, **kw)
    assert p2.mean.shape == (40, 1) and p2.var.shape == (40, 1)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_array_equal(getattr(p1, f), getattr(p2, f)[:, 0], err_msg=f)


def test_convert_round_trips_and_params_api(problem):
    _, _, ref_p, p, _ = problem
    for a, b in zip(multi_params_to_reference(p), _leaves(ref_p)):
        np.testing.assert_array_equal(a, b)
    assert p.n_outputs == 3
    np.testing.assert_allclose(p.nugget.numpy(), np.asarray(ref_p.nugget), rtol=1e-15)
    for j in range(3):
        for a, b in zip(p.output_params(j), ref_p.output_params(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    c = mo.MultiOutputParams.create(sigma2=2.0, beta=0.5, tau2=1e-3, d=4, p=2)
    assert c.log_sigma2.shape == (2,) and c.log_beta.shape == (4,) and c.log_tau2.shape == ()
    kp = p.output_params(1)
    back = mo.as_multi_params(kp, 3, 3)
    np.testing.assert_allclose(back.sigma2.numpy(), float(kp.sigma2), rtol=1e-15)
    np.testing.assert_allclose(float(back.tau2), float(p.tau2), rtol=1e-12)
    with pytest.raises(TypeError):
        mo.as_multi_params(object(), 3, 3)


@pytest.mark.parametrize("kw", [{"tuning": object()}, {"stream_chunk": 100, "n_buckets": 2},
                                {"stream_chunk": 100, "device_cache": 2, "multihost": object()},
                                {"stream_chunk": 100, "distributed": object()},
                                {"distributed": object()}])
def test_multi_unported_options_raise(problem, kw):
    """Unported multi-output options raise ``NotImplementedError``; tuning
    records are ported, and a ``tuning`` that is no record is a
    ``TypeError``."""
    x, y, _, _, _ = problem
    with pytest.raises(TypeError if "tuning" in kw else NotImplementedError):
        fit_sbv(x, y, SBVConfig(n_blocks=16, m=20), device="cpu", **kw)


def test_multi_stats_wrapper_never_runs_the_plain_version_for_cuda(problem):
    """Asked for the kernel on CPU tensors, the wrapper raises; it does not
    hand back the plain version's numbers or count a launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sbv_multi_stats import sbv_multi_stats_cuda

    _, _, _, p, packed = problem
    p0 = p.structure_params()
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sbv_multi_stats_cuda(p0.beta, p0.sigma2, p0.nugget, *vecchia.packed_arrays(packed, "cpu"))
    with pytest.raises(ValueError, match=r"\(bc, bs, p\)"):
        sbv_multi_stats_cuda(p0.beta, p0.sigma2, p0.nugget, *vecchia.packed_arrays(
            packed, "cpu")[:1], torch.zeros(packed.blk_mask.shape), *vecchia.packed_arrays(
                packed, "cpu")[2:])
    # A bucketed layout goes through the same wrappers: on CPU tensors, the
    # plain version per bucket, with no launch counted.
    from repro_torch.core.buckets import bucket_blocks

    ld_b, q_b = mo.packed_multi_stats(p, bucket_blocks(packed, n_buckets=3))
    ld_u, q_u = mo.packed_multi_stats(p, packed)
    assert _build.LAUNCHES == before
    np.testing.assert_allclose(float(ld_b), float(ld_u), rtol=1e-10)
    np.testing.assert_allclose(q_b.numpy(), q_u.numpy(), rtol=1e-10)
