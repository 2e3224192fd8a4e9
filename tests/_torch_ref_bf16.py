"""The reference's bf16-tier values on its kernel route, for the port's tests.

Run as a script (``python tests/_torch_ref_bf16.py OUT.npz``) by
tests/test_torch_precision.py, in a process of its own started with
``XLA_FLAGS=--xla_allow_excess_precision=false``. The reference's Pallas
kernels scale the coordinates at storage width, ``z = xb /
beta.astype(xb.dtype)``; on the CPU, interpret mode runs that inside a jit,
and XLA's default excess precision then keeps the quotient in f32 instead
of rounding it to bf16 (on the test data up to one bf16 ulp per scaled
coordinate, which moves a block's log-density by up to 1 %). With excess
precision off the interpret-mode kernels compute the narrow tier as
written. The flag is process-wide and read when XLA starts, so it cannot
be set inside the test process, where other tests have started XLA
already; hence the separate process.
"""
import sys

import numpy as np


def problem():
    """The skewed data of tests/test_buckets.py, its uniform packing at the
    reference test's structure, and three-output observations for the
    multi-output stats (the first output is y)."""
    from test_buckets import PAR, skewed_data

    from repro.core import SBVConfig, preprocess

    x, y = skewed_data()
    packed, _ = preprocess(x, y, PAR.beta, SBVConfig(n_blocks=20, m=25, clustering="kmeans"))
    rng = np.random.default_rng(5)
    y3 = np.stack([y, np.sin(3.0 * x.sum(axis=1)), rng.normal(size=x.shape[0])], axis=1)
    packed_m, _ = preprocess(x, y3, PAR.beta, SBVConfig(n_blocks=20, m=25, clustering="kmeans"))
    return x, y, y3, packed, packed_m


def queries(x):
    rng = np.random.default_rng(11)
    return rng.uniform(x.min(0), x.max(0), size=(120, x.shape[1]))


def main(out: str) -> None:
    import jax.numpy as jnp

    from test_buckets import PAR

    from repro.core.buckets import (PrecisionPolicy, assign_precision, bucket_blocks,
                                    cast_packed, cast_prediction, bucket_prediction)
    from repro.core.multioutput import MultiOutputParams
    from repro.core.predict import build_train_index, pack_queries, predict_sbv
    from repro.kernels import ops
    from repro.kernels.sbv_loglik import sbv_loglik_pallas, sbv_multi_stats_pallas
    from repro.kernels.sbv_predict import sbv_predict_pallas

    x, y, _, packed, packed_m = problem()
    f32 = jnp.float32
    res = {}
    s = lambda a: jnp.asarray(a, f32)
    for i, pk in enumerate(bucket_blocks(packed, n_buckets=3).buckets):
        c = cast_packed(pk, "bf16")
        res[f"loglik_{i}"] = np.asarray(sbv_loglik_pallas(
            s(PAR.beta), s(PAR.sigma2), s(PAR.nugget), jnp.asarray(c.blk_x), jnp.asarray(c.blk_y),
            s(c.blk_mask), jnp.asarray(c.nn_x), jnp.asarray(c.nn_y), s(c.nn_mask)))
    mp = MultiOutputParams.create(sigma2=[0.5, 1.0, 1.5], beta=np.asarray(PAR.beta), tau2=1e-2,
                                  d=3, p=3)
    p0 = mp.structure_params()
    for i, pk in enumerate(bucket_blocks(packed_m, n_buckets=3).buckets):
        c = cast_packed(pk, "bf16")
        res[f"multi_{i}"] = np.asarray(sbv_multi_stats_pallas(
            s(p0.beta), s(p0.sigma2), s(p0.nugget), jnp.asarray(c.blk_x), jnp.asarray(c.blk_y),
            s(c.blk_mask), jnp.asarray(c.nn_x), jnp.asarray(c.nn_y), s(c.nn_mask)))
    index = build_train_index(x, y, np.asarray(PAR.beta), 30)
    qp = pack_queries(index, queries(x), 10, 30)
    for i, pk in enumerate(bucket_prediction(qp, n_buckets=3).buckets):
        c = cast_prediction(pk, "bf16")
        mu, var = sbv_predict_pallas(s(PAR.beta), s(PAR.sigma2), s(PAR.nugget),
                                     jnp.asarray(c.q_x), s(c.q_mask), jnp.asarray(c.nn_x),
                                     jnp.asarray(c.nn_y), s(c.nn_mask))
        res[f"predict_mu_{i}"], res[f"predict_var_{i}"] = np.asarray(mu), np.asarray(var)
    xj = np.concatenate([packed.nn_x, packed.blk_x], axis=1)[:4]
    res["cov"] = np.asarray(ops.matern_cov(jnp.asarray(xj, jnp.bfloat16),
                                           jnp.asarray(xj, jnp.bfloat16), PAR))

    bucketed = bucket_blocks(packed, n_buckets=3)
    for tier in ("bf16", "f32"):
        res[f"tiers_{tier}"] = np.asarray(
            assign_precision(PAR, bucketed, PrecisionPolicy(tier), backend="pallas"))
    pred = predict_sbv(PAR, x, y, queries(x), bs_pred=10, m_pred=30, n_sims=2, seed=3,
                       n_buckets=3, precision="bf16", backend="pallas")
    for f in ("mean", "var", "sim_mean", "ci_low"):
        res[f"pred_{f}"] = getattr(pred, f)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
