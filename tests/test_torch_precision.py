"""Port vs reference: the precision ladder on the CPU.

Data: the skewed clustered inputs of tests/test_buckets.py in three buckets.

* Gradients (ROADMAP fault 3, repaired): the kernel route's gradient at the
  f32 and bf16 tiers is the f64 plain version on the narrow-stored data, as
  the reference's ``custom_vjp`` backward computes it under jnp promotion;
  held to ``jax.grad`` through the reference's ``pallas`` route at rtol 1e-8
  (tests/test_kernels_pallas.py). The functionals are linear in the
  kernel's outputs, so no forward value enters the cotangents.
* The plain narrow versions (the bf16-assembly body: z = bf16(x /
  bf16(beta)), f32 Gram and Cholesky, pivots clamped at 2^-7 * sigma2) are
  held to the reference's interpret-mode Pallas kernels on the same bf16
  coordinates, computed in a separate process with XLA's excess precision
  off (tests/_torch_ref_bf16.py says why). Both run in f32 in different
  orders; on these inputs each is within 1.5e-4 (relative, per block) of
  the same bf16-assembly math in f64, so they are held to 1e-3 of
  max(1, |value|) per block (likelihood, multi-output stats), predictions to
  1e-3 of max(1, |mean|), and the covariance to f32's 1e-5.
* Tiers, fits and predictions: the port's ``ref`` route against the
  reference's ``ref`` route (in this process), the port's kernel route
  (``auto``) against the reference's ``pallas`` route (the separate
  process). The bf16 ``ref`` route evaluates f32 Cholesky factors of
  blocks whose nugget is 1e-3 of sigma2; XLA's and torch's f32
  factorizations differ there by up to 6e-5 relative in the fit loss, so
  its fit losses are held to 2e-4.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ref_bf16 as ref_bf16  # noqa: E402
from test_buckets import PAR, skewed_data  # noqa: E402

from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import buckets as ref_buckets  # noqa: E402
from repro.core import multioutput as ref_mo  # noqa: E402
from repro.core import vecchia as ref_vecchia  # noqa: E402
from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.predict import predict_sbv as ref_predict_sbv  # noqa: E402
from repro.kernels.sbv_loglik import sbv_loglik_pallas  # noqa: E402
from repro_torch.convert import multi_params_from_reference, params_from_reference  # noqa: E402
from repro_torch.core import SBVConfig, buckets, preprocess, vecchia  # noqa: E402
from repro_torch.core import multioutput as mo  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.matern_cov import matern_cov_plain  # noqa: E402
from repro_torch.kernels.sbv_loglik import sbv_loglik_plain  # noqa: E402
from repro_torch.kernels.sbv_multi_stats import sbv_multi_stats_plain  # noqa: E402
from repro_torch.kernels.sbv_predict import sbv_predict_plain  # noqa: E402

HERE = Path(__file__).resolve().parent
P = params_from_reference(*(np.asarray(a) for a in PAR))
MP_REF = ref_mo.MultiOutputParams.create(sigma2=[0.5, 1.0, 1.5], beta=np.asarray(PAR.beta),
                                         tau2=1e-2, d=3, p=3)
MP = multi_params_from_reference(*(np.asarray(a) for a in MP_REF))
TOL, PRED_TOL = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _ref_process(tmp_path_factory):
    """Start the reference's bf16 kernel-route run (tests/_torch_ref_bf16.py)
    when the module starts, so it runs beside the in-process tests."""
    out = tmp_path_factory.mktemp("ref_bf16") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    src = str(HERE.parent / "src")
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src, str(HERE), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(HERE / "_torch_ref_bf16.py"), str(out)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_kernel_route(_ref_process):
    proc, out = _ref_process
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def problem():
    """(x, y, y3, packed, packed_m) of the reference process, packed by the
    port (bitwise the reference's packing: tests/test_torch_buckets.py)."""
    x, y = skewed_data()
    y3 = ref_bf16.problem()[2]
    cfg = SBVConfig(n_blocks=20, m=25, clustering="kmeans")
    packed, _ = preprocess(x, y, np.asarray(PAR.beta), cfg)
    packed_m, _ = preprocess(x, y3, np.asarray(PAR.beta), cfg)
    return x, y, y3, packed, packed_m


def _ref_cast(packed, tier):
    """The reference's cast of the same uniform packing."""
    from repro.core.packing import PackedBlocks as RefPacked

    ref_pk = RefPacked(**{f: np.asarray(getattr(packed, f)) for f in
                          ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask", "owners")})
    return ref_buckets.cast_packed(ref_pk, tier)


# -- the repaired gradient (ROADMAP fault 3) ---------------------------------

@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_loglik_kernel_route_gradient_matches_reference(problem, tier):
    _, _, _, packed, _ = problem
    want = jax.grad(lambda q: ref_vecchia.packed_loglik(q, _ref_cast(packed, tier),
                                                        backend="pallas"))(PAR)
    leaves = [t.clone().requires_grad_(True) for t in P]
    ll = vecchia.packed_loglik(type(P)(*leaves), buckets.cast_packed(packed, tier))
    assert ll.dtype == torch.float32
    for a, b in zip(torch.autograd.grad(ll, leaves), want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_multi_stats_kernel_route_gradient_matches_reference(problem, tier):
    _, _, _, _, packed_m = problem
    w = np.asarray([0.5, 1.0, 2.0])

    def ref_obj(q):
        ld, q0 = ref_mo.packed_multi_stats(q, _ref_cast(packed_m, tier), backend="pallas")
        return ld + jnp.sum(jnp.asarray(w, q0.dtype) * q0)

    want = jax.grad(ref_obj)(MP_REF)
    leaves = [t.clone().requires_grad_(True) for t in MP]
    ld, q0 = mo.packed_multi_stats(mo.MultiOutputParams(*leaves),
                                   buckets.cast_packed(packed_m, tier))
    got = torch.autograd.grad(ld + torch.sum(torch.as_tensor(w, dtype=q0.dtype) * q0),
                              leaves[1:])
    for a, b in zip(got, want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)


def test_gradient_is_the_f64_plain_version_on_narrow_data(problem):
    """The f32 tier's kernel-route gradient equals autograd through the f64
    plain version on the f32-stored data (the reference's pallas-route
    gradient is that f64 computation)."""
    _, _, _, packed, _ = problem
    pk = buckets.cast_packed(packed, "f32")

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in P]
        return torch.autograd.grad(fn(type(P)(*leaves)), leaves)

    arrs64 = tuple(a.double() if a.is_floating_point() else a
                   for a in vecchia.packed_arrays(pk, "cpu"))
    for a, b in zip(grads(lambda q: vecchia.packed_loglik(q, pk)),
                    grads(lambda q: vecchia.batched_block_loglik(q, *arrs64))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-15)


def test_indefinite_bf16_schur_block_stays_finite_like_the_kernel():
    """Three block points 1e-4 apart round to one bf16 coordinate: with a
    nugget far below f32's resolution of sigma2 the bf16 Schur complement
    is singular. The narrow plain version, like the reference's Pallas
    kernel, clamps the pivots at 2^-7 * sigma2 and stays finite; the ``ref``
    form (no floor) gives NaN in both packages."""
    rng = np.random.default_rng(0)
    nn_x = rng.uniform(size=(1, 4, 3))
    blk_x = np.full((1, 3, 3), 0.5) + 1e-4 * np.arange(3)[None, :, None]
    blk_y, nn_y = rng.normal(size=(1, 3)), rng.normal(size=(1, 4))
    ones = lambda n: np.ones((1, n), dtype=bool)
    beta, sigma2, nugget = np.asarray([0.3, 0.5, 2.0]), 1.3, 1e-9
    bx16 = torch.as_tensor(blk_x).bfloat16()
    assert bool((bx16[0, 0] == bx16[0, 1]).all() and (bx16[0, 1] == bx16[0, 2]).all())
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    ops_args = (bx16, t32(blk_y), torch.as_tensor(ones(3)), torch.as_tensor(nn_x).bfloat16(),
                t32(nn_y), torch.as_tensor(ones(4)))
    narrow = sbv_loglik_plain(t32(beta), t32(sigma2), t32(nugget), *ops_args)
    ref_form = vecchia.block_loglik(t32(beta), t32(sigma2), t32(nugget), *ops_args)
    assert bool(torch.isfinite(narrow).all())
    assert not bool(torch.isfinite(ref_form).any())
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    pallas = sbv_loglik_pallas(f32(beta), f32(sigma2), f32(nugget), j16(blk_x), f32(blk_y),
                               f32(ones(3)), j16(nn_x), f32(nn_y), f32(ones(4)))
    rp = ref_vecchia.KernelParams.create(sigma2=sigma2, beta=beta, nugget=nugget)
    ref_nll = ref_vecchia.batched_block_loglik(
        ref_vecchia.KernelParams(*(jnp.asarray(a, jnp.float32) for a in rp)), j16(blk_x),
        f32(blk_y), ones(3), j16(nn_x), f32(nn_y), ones(4))
    assert bool(np.isfinite(np.asarray(pallas)).all())
    assert not bool(np.isfinite(np.asarray(ref_nll)))


# -- tiers, fits and predictions ---------------------------------------------

def test_bf16_bucketed_fit_matches_reference_ref_route():
    """The reference's ``test_precision_fit_and_predict_mspe`` on both
    packages' ``ref`` routes: tiers equal, losses at 2e-4, and the bf16
    prediction at the fitted params within a relative RMS of 0.1 of f64."""
    x, y = skewed_data()
    kw = dict(inner_steps=4, outer_rounds=1, n_buckets=3, precision="bf16", backend="ref")
    want = ref_fit(x, y, RefConfig(n_blocks=12, m=15), **kw)
    got = fit_sbv(x, y, SBVConfig(n_blocks=12, m=15), device="cpu", **kw)
    assert got.precision_tiers == want.precision_tiers
    assert "bf16" in got.precision_tiers
    losses = [h[2] for h in got.history]
    np.testing.assert_allclose(losses, [h[2] for h in want.history], rtol=2e-4)
    assert losses[-1] < losses[0]
    assert [buckets.dtype_tier(pk.blk_x.dtype) for pk in got.packed.buckets] == \
        got.precision_tiers
    xt = ref_bf16.queries(x)
    kw = dict(bs_pred=10, m_pred=30, n_sims=2, device="cpu", backend="ref")
    p64 = tpredict.predict_sbv(got.params, x, y, xt, **kw)
    p16 = tpredict.predict_sbv(got.params, x, y, xt, precision="bf16", **kw)
    assert np.all(np.isfinite(p16.mean)) and np.all(p16.var > 0)
    rel = np.sqrt(np.mean((p16.mean - p64.mean) ** 2)) / np.sqrt(np.mean(p64.mean ** 2))
    assert rel < 0.1, rel


def test_multi_output_bf16_within_tier_budget():
    """The multi-output bf16 path against f64 values and the tier budget,
    not against the reference's bf16 output (ROADMAP, carried context), on
    the reference's own fixture (tests/test_multioutput.py: n 500, d 3,
    p 3, params fitted in 4 steps) and on its ``ref`` route: per-output
    log-likelihoods of the cast layout, uniform and bucketed, and the
    cast-only bucketed fit's losses. (The kernel route clamps the unit-
    variance pivots at 2^-7, above this fit's relative nugget: ROADMAP
    fault 4.)"""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(500, 3))
    y = np.stack([np.sin(x @ rng.uniform(1.0, 3.0, size=3)) + 0.01 * rng.standard_normal(500)
                  for _ in range(3)], axis=1)
    cfg = SBVConfig(n_blocks=16, m=20, seed=0)
    params = fit_sbv(x, y, cfg, inner_steps=4, outer_rounds=1, device="cpu").params
    packed, _ = preprocess(x, y, params.beta.numpy(), cfg)
    ll64 = mo.multi_loglik(params, packed, backend="ref").numpy()
    for layout in (packed, buckets.bucket_blocks(packed, n_buckets=3)):
        cast = (buckets.cast_packed(layout, "bf16") if layout is packed
                else buckets.apply_precision(layout, "bf16"))
        ll16 = mo.multi_loglik(params, cast, backend="ref").numpy()
        rel = np.abs(ll16 - ll64) / np.maximum(1.0, np.abs(ll64))
        assert np.all(rel <= buckets._TIER_BUDGETS["bf16"]), rel
    kw = dict(inner_steps=3, outer_rounds=1, n_buckets=3, device="cpu", backend="ref")
    f16 = fit_sbv(x, y, cfg, precision="bf16", **kw)
    f64 = fit_sbv(x, y, cfg, **kw)
    assert [buckets.dtype_tier(pk.blk_x.dtype) for pk in f16.packed.buckets] == \
        ["bf16"] * f16.packed.n_buckets
    l16, l64 = (np.asarray([h[2] for h in f.history]) for f in (f16, f64))
    assert np.all(np.isfinite(l16)) and l16[-1] < l16[0]
    assert np.all(np.abs(l16 - l64) / np.maximum(1.0, np.abs(l64))
                  <= buckets._TIER_BUDGETS["bf16"])


@pytest.mark.parametrize("tier", ["bf16", "f32"])
@pytest.mark.parametrize("route", ["ref", "auto"])
def test_assign_precision_tiers_match_reference(problem, request, route, tier):
    _, _, _, packed, _ = problem
    got = buckets.assign_precision(P, buckets.bucket_blocks(packed, n_buckets=3),
                                   buckets.PrecisionPolicy(tier), backend=route)
    if route == "ref":
        ref_pk = _ref_cast(packed, "f64")
        want = ref_buckets.assign_precision(PAR, ref_buckets.bucket_blocks(ref_pk, 3),
                                            ref_buckets.PrecisionPolicy(tier), backend="ref")
    else:
        want = request.getfixturevalue("ref_kernel_route")[f"tiers_{tier}"].tolist()
    assert got == want
    for pk, t in zip(buckets.bucket_blocks(packed, n_buckets=3).buckets, got):
        f64 = float(vecchia.packed_loglik(P, pk, backend=route))
        at_t = float(vecchia.packed_loglik(P, buckets.cast_packed(pk, t), backend=route))
        assert abs(at_t - f64) / max(1.0, abs(f64)) <= buckets.PrecisionPolicy(tier).budget_for(t)


# -- the kernel route against the reference's kernels (the separate process) --

def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def test_loglik_narrow_plain_matches_reference_kernel(problem, ref_kernel_route):
    _, _, _, packed, _ = problem
    p32 = tuple(t.float() for t in (P.beta, P.sigma2, P.nugget))
    for i, pk in enumerate(buckets.bucket_blocks(packed, n_buckets=3).buckets):
        arrs = vecchia.packed_arrays(buckets.cast_packed(pk, "bf16"), "cpu")
        assert arrs[0].dtype == torch.bfloat16
        got = sbv_loglik_plain(*p32, *arrs)
        assert got.dtype == torch.float32
        assert _rel(got, ref_kernel_route[f"loglik_{i}"]) <= TOL, i


def test_multi_stats_narrow_plain_matches_reference_kernel(problem, ref_kernel_route):
    _, _, _, _, packed_m = problem
    s0 = MP.structure_params()
    p32 = tuple(t.float() for t in (s0.beta, s0.sigma2, s0.nugget))
    for i, pk in enumerate(buckets.bucket_blocks(packed_m, n_buckets=3).buckets):
        arrs = vecchia.packed_arrays(buckets.cast_packed(pk, "bf16"), "cpu")
        got = sbv_multi_stats_plain(*p32, *arrs)
        assert got.shape == ref_kernel_route[f"multi_{i}"].shape
        assert _rel(got, ref_kernel_route[f"multi_{i}"]) <= TOL, i


def test_predict_narrow_plain_matches_reference_kernel(problem, ref_kernel_route):
    x, y, _, _, _ = problem
    index = tpredict.build_train_index(x, y, np.asarray(PAR.beta), 30)
    qp = tpredict.pack_queries(index, ref_bf16.queries(x), 10, 30)
    p32 = tuple(t.float() for t in (P.beta, P.sigma2, P.nugget))
    for i, pk in enumerate(buckets.bucket_prediction(qp, n_buckets=3).buckets):
        arrs = tuple(torch.as_tensor(a) for a in buckets.cast_prediction(pk, "bf16").arrays())
        mu, var = sbv_predict_plain(*p32, *arrs)
        msk = pk.q_mask
        for got, key in ((mu, "mu"), (var, "var")):
            want = ref_kernel_route[f"predict_{key}_{i}"]
            scale = max(1.0, float(np.abs(want[msk]).max()))
            assert float(np.abs(got.numpy() - want)[msk].max()) <= PRED_TOL * scale, (i, key)


def test_matern_cov_narrow_plain_matches_reference_kernel(problem, ref_kernel_route):
    _, _, _, packed, _ = problem
    xj = torch.as_tensor(np.concatenate([packed.nn_x, packed.blk_x], axis=1)[:4]).bfloat16()
    got = ops.matern_cov(xj, xj, P)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_kernel_route["cov"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), matern_cov_plain(
        xj, xj, P.beta.float(), P.sigma2.float()).numpy())


def _ref_draws(seed, dtype):
    def eps(ci, bi, shape):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), ci), bi)
        return np.asarray(jax.random.normal(key, shape, dtype=dtype))
    return eps


def test_bf16_bucketed_predict_matches_reference(problem, ref_kernel_route):
    """The kernel route against the reference's pallas route, with the
    reference's per-bucket draws (f32, the route's output dtype) injected;
    the ``ref`` route (an f64 computation on the bf16 coordinates under
    promotion, in both packages) at 1e-10."""
    x, y, _, _, _ = problem
    xt = ref_bf16.queries(x)
    kw = dict(bs_pred=10, m_pred=30, n_sims=2, seed=3, n_buckets=3, precision="bf16")
    got = tpredict.predict_sbv(P, x, y, xt, device="cpu", eps=_ref_draws(3, jnp.float32), **kw)
    scale = max(1.0, float(np.abs(ref_kernel_route["pred_mean"]).max()))
    for f in ("mean", "var", "sim_mean", "ci_low"):
        np.testing.assert_allclose(getattr(got, f), ref_kernel_route[f"pred_{f}"], rtol=0,
                                   atol=PRED_TOL * scale, err_msg=f)
    got_ref = tpredict.predict_sbv(P, x, y, xt, device="cpu", backend="ref",
                                   eps=_ref_draws(3, jnp.float64), **kw)
    want_ref = ref_predict_sbv(PAR, x, y, xt, backend="ref", **kw)
    for f in ("mean", "var", "sim_mean", "ci_low"):
        np.testing.assert_allclose(getattr(got_ref, f), getattr(want_ref, f), rtol=1e-10,
                                   atol=1e-12, err_msg=f)
