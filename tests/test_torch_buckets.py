"""Port vs reference: bucketed execution and the ladder's casts, on the CPU.

Data: the skewed clustered inputs of tests/test_buckets.py (``skewed_data``:
10 lognormal-sized clusters in 3-d), packed with its structure (20 k-means
blocks, m = 25). Bucket partitions (ceilings, ranks, padded arrays) and the
ladder's casts are held bitwise to the reference's, the bf16 coordinates
through an int16 view. Bucketed likelihoods, multi-output stats, predictions
and fits in f64 are held to the uniform layout and to the reference at
1e-10 (docs/packing.md), except a fit's later steps: the reference takes
each Adam update in float32 and XLA and torch may round it one ulp apart,
so they are held at 1e-6 (as in tests/test_torch_slice.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_buckets import PAR, skewed_data  # noqa: E402

from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import buckets as ref_buckets  # noqa: E402
from repro.core import multioutput as ref_mo  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core import vecchia as ref_vecchia  # noqa: E402
from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.predict import build_train_index as ref_index  # noqa: E402
from repro.core.predict import pack_queries as ref_pack_queries  # noqa: E402
from repro.core.predict import predict_sbv as ref_predict_sbv  # noqa: E402
from repro_torch.convert import (multi_params_from_reference,  # noqa: E402
                                 params_from_reference, params_to_reference)
from repro_torch.core import SBVConfig, buckets, preprocess, vecchia  # noqa: E402
from repro_torch.core import multioutput as mo  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FIELDS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask", "owners")
PRED_FIELDS = ("q_x", "q_mask", "q_idx", "nn_x", "nn_y", "nn_mask", "owners")
P = params_from_reference(*(np.asarray(a) for a in PAR))


def _cfg(cls):
    return cls(n_blocks=20, m=25, clustering="kmeans")


@pytest.fixture(scope="module")
def skewed():
    x, y = skewed_data()
    ref, _ = ref_preprocess(x, y, PAR.beta, _cfg(RefConfig))
    got, _ = preprocess(x, y, np.asarray(PAR.beta), _cfg(SBVConfig))
    return x, y, ref, got


def _queries(x, seed=4):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(size=(150, 3)), x[:40] + 0.01 * rng.normal(size=(40, 3))])


def _bits(a):
    """Raw bits of a coordinate array: bf16 (torch tensor or ml_dtypes
    array) as int16, anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("n_buckets", [1, 2, 4, 10_000])
def test_bucket_blocks_bitwise_reference(skewed, n_buckets):
    _, _, ref, got = skewed
    want = ref_buckets.bucket_blocks(ref, n_buckets=n_buckets)
    have = buckets.bucket_blocks(got, n_buckets=n_buckets)
    for size_fn in ("blk_mask", "nn_mask"):
        sizes = getattr(got, size_fn).sum(axis=1)
        np.testing.assert_array_equal(buckets.bucket_ceilings(sizes, n_buckets),
                                      ref_buckets.bucket_ceilings(sizes, n_buckets))
    assert have.n_buckets == want.n_buckets
    assert (have.n_blocks, have.n_points) == (want.n_blocks, want.n_points)
    for a, b in zip(have.ranks, want.ranks):
        np.testing.assert_array_equal(a, b)
    for pa, pb in zip(have.buckets, want.buckets):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f), err_msg=f)
    assert have.occupancy() == want.occupancy()
    assert buckets.loglik_work(have.buckets) == ref_buckets.loglik_work(want.buckets)


@pytest.mark.parametrize("n_buckets", [2, 4])
def test_bucket_prediction_bitwise_reference(skewed, n_buckets):
    x, y, _, _ = skewed
    xt = _queries(x)
    want = ref_pack_queries(ref_index(x, y, np.asarray(PAR.beta), 40), xt, 8, 40)
    got = tpredict.pack_queries(tpredict.build_train_index(x, y, np.asarray(PAR.beta), 40),
                                xt, 8, 40)
    wb = ref_buckets.bucket_prediction(want, n_buckets=n_buckets)
    gb = buckets.bucket_prediction(got, n_buckets=n_buckets)
    assert gb.n_buckets == wb.n_buckets and gb.n_queries == wb.n_queries
    for a, b in zip(gb.ranks, wb.ranks):
        np.testing.assert_array_equal(a, b)
    for pa, pb in zip(gb.buckets, wb.buckets):
        for f in PRED_FIELDS:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f), err_msg=f)
    assert gb.occupancy() == wb.occupancy()
    assert gb.occupancy() > buckets.prediction_work([got])[0] / buckets.prediction_work([got])[1]


@pytest.mark.parametrize("tier", ["bf16", "f32", "f64"])
def test_cast_packed_and_prediction_bitwise_reference(skewed, tier):
    x, y, ref, got = skewed
    rb = ref_buckets.bucket_blocks(ref, n_buckets=3)
    gb = buckets.bucket_blocks(got, n_buckets=3)
    for pa, pb in zip(ref_buckets.apply_precision(rb, tier).buckets,
                      buckets.apply_precision(gb, tier).buckets):
        for f in FIELDS:
            np.testing.assert_array_equal(_bits(getattr(pb, f)), _bits(getattr(pa, f)),
                                          err_msg=f)
        assert buckets.dtype_tier(pb.blk_x.dtype) == tier
        assert (pb.blk_y.dtype, pb.blk_mask.dtype) == (buckets.acc_dtype(tier), np.bool_)
    assert buckets.storage_dtype("bf16") == torch.bfloat16
    xt = _queries(x)
    want = ref_buckets.cast_prediction(ref_pack_queries(
        ref_index(x, y, np.asarray(PAR.beta), 40), xt, 8, 40), tier)
    have = buckets.cast_prediction(tpredict.pack_queries(
        tpredict.build_train_index(x, y, np.asarray(PAR.beta), 40), xt, 8, 40), tier)
    for f in PRED_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(have, f)), _bits(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("n_buckets", [1, 2, 4])
def test_bucketed_loglik_matches_uniform_and_reference(skewed, n_buckets, backend):
    _, _, ref, got = skewed
    bucketed = buckets.bucket_blocks(got, n_buckets=n_buckets)
    uniform = float(vecchia.packed_loglik(P, got, backend=backend))
    have = float(vecchia.packed_loglik(P, bucketed, backend=backend))
    want = float(ref_vecchia.packed_loglik(PAR, ref_buckets.bucket_blocks(ref, n_buckets)))
    np.testing.assert_allclose(have, uniform, rtol=1e-10)
    np.testing.assert_allclose(have, want, rtol=1e-10)


def test_bucketed_loglik_gradient_matches_uniform(skewed):
    _, _, _, got = skewed

    def grads(packed):
        leaves = [t.clone().requires_grad_(True) for t in P]
        ll = vecchia.packed_loglik(type(P)(*leaves), packed)
        return torch.autograd.grad(ll, leaves)

    for a, b in zip(grads(buckets.bucket_blocks(got, n_buckets=4)), grads(got)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_bucketed_multi_stats_match_uniform_and_reference(skewed, backend):
    x, y, _, _ = skewed
    y3 = np.stack([y, np.sin(3.0 * x.sum(axis=1)), np.cos(x[:, 0])], axis=1)
    mp_ref = ref_mo.MultiOutputParams.create(sigma2=[0.5, 1.0, 1.5], beta=np.asarray(PAR.beta),
                                             tau2=1e-2, d=3, p=3)
    mp = multi_params_from_reference(*(np.asarray(a) for a in mp_ref))
    ref, _ = ref_preprocess(x, y3, PAR.beta, _cfg(RefConfig))
    got, _ = preprocess(x, y3, np.asarray(PAR.beta), _cfg(SBVConfig))
    ld_u, q_u = mo.packed_multi_stats(mp, got, backend=backend)
    ld_b, q_b = mo.packed_multi_stats(mp, buckets.bucket_blocks(got, n_buckets=3),
                                      backend=backend)
    ld_r, q_r = ref_mo.packed_multi_stats(mp_ref, ref_buckets.bucket_blocks(ref, 3))
    np.testing.assert_allclose(float(ld_b), float(ld_u), rtol=1e-10)
    np.testing.assert_allclose(q_b.numpy(), q_u.numpy(), rtol=1e-10)
    np.testing.assert_allclose(float(ld_b), float(ld_r), rtol=1e-10)
    np.testing.assert_allclose(q_b.numpy(), np.asarray(q_r), rtol=1e-10)
    for a, b in zip(mo._cast_multi(mp, torch.float32), ref_mo._cast_multi(mp_ref, jnp.float32)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ref_draws(seed, dtype=jnp.float64):
    """The reference's simulation noise: per chunk, and per bucket."""
    def eps(ci, bi, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        if bi is not None:
            key = jax.random.fold_in(key, bi)
        return np.asarray(jax.random.normal(key, shape, dtype=dtype))
    return eps


@pytest.mark.parametrize("n_buckets,chunk_size", [(4, None), (2, 96)])
def test_bucketed_predict_matches_uniform_and_reference(n_buckets, chunk_size):
    x, y = skewed_data(seed=3)
    xt = _queries(x)
    kw = dict(bs_pred=8, m_pred=40, seed=0, n_sims=4, chunk_size=chunk_size)
    uniform = tpredict.predict_sbv(P, x, y, xt, device="cpu", **kw)
    got = tpredict.predict_sbv(P, x, y, xt, device="cpu", n_buckets=n_buckets,
                               eps=_ref_draws(0), **kw)
    want = ref_predict_sbv(PAR, x, y, xt, n_buckets=n_buckets, **kw)
    for f in ("mean", "var"):
        np.testing.assert_allclose(getattr(got, f), getattr(uniform, f), atol=1e-10, rtol=0)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=1e-10, rtol=1e-10,
                                   err_msg=f)


def test_bucketed_fit_history_matches_reference():
    x, y = skewed_data(seed=9, n_clusters=6)
    init = PAR._replace(log_sigma2=jnp.log(jnp.asarray(float(np.var(y)))),
                        log_nugget=jnp.log(jnp.asarray(1e-2)))
    kw = dict(inner_steps=4, outer_rounds=2, n_buckets=3)
    want = ref_fit(x, y, RefConfig(n_blocks=8, m=15), init=init, **kw)
    got = fit_sbv(x, y, SBVConfig(n_blocks=8, m=15),
                  init=params_from_reference(*(np.asarray(a) for a in init)), device="cpu",
                  **kw)
    assert isinstance(got.packed, buckets.BucketedBlocks)  # re-bucketed each refresh
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    losses, ref_losses = [h[2] for h in got.history], [h[2] for h in want.history]
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-10)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    assert losses[-1] < losses[0]
    for a, b in zip(params_to_reference(got.params), (np.asarray(a) for a in want.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for pa, pb in zip(got.packed.buckets, want.packed.buckets):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


@pytest.mark.parametrize("kind", ["loglik", "predict"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_select_backend_is_the_kernel_for_every_shape(kind, dtype):
    """The Hopper policy: every bucket shape and ladder dtype takes the
    kernel route, 'auto' (the CUDA kernels take any bs and m), and buckets
    align to exact geometric ceilings; the TPU tiles are not copied."""
    for bs, m in ((1, 1), (7, 13), (8, 128), (16, 128), (340, 200)):
        assert ops.select_backend(bs, m, kind=kind, dtype=dtype) == "auto"
    assert ops.ladder_dtypes(dtype) == ((torch.bfloat16, torch.float32)
                                        if dtype == torch.bfloat16 else (dtype, dtype))
    for backend in ("auto", "ref", "pallas_tiled"):
        for tier in (None, "bf16", "f32"):
            assert buckets.bucket_mults(backend, precision=tier) == (1, 1)
    with pytest.raises(ValueError):
        ops.select_backend(8, 8, kind="train")
