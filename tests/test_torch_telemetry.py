"""Port vs reference: serving telemetry (tests/test_telemetry.py's cases).

``serving/telemetry.py`` is a pure-Python copy, so each case runs the same
calls on the port's ``ServerStats`` and on the reference's and holds the
port to the reference's assertions and to the reference's summary, key for
key (exact floats; the throughput ``points_per_s`` reads the wall clock and
is left out).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import telemetry as ref_tm  # noqa: E402
from repro_torch.serving import telemetry as tm  # noqa: E402


def _trace(mod, n_points, submit, dispatch, done):
    t = mod.RequestTrace(n_points=n_points, t_submit=submit)
    t.t_dispatch = dispatch
    t.t_done = done
    return t


def _both(fn, **kw):
    """Run ``fn(module, stats)`` on both packages; return the port's stats
    after holding its summary to the reference's."""
    out = []
    for mod in (tm, ref_tm):
        stats = mod.ServerStats(**kw)
        fn(mod, stats)
        out.append(stats)
    got, want = (s.summary() for s in out)
    for s in (got, want):
        s.pop("points_per_s")
    assert got == want
    return out[0]


def test_percentile_nearest_rank_math():
    vals = [0.1, 0.2, 0.3, 0.4, 0.5]
    for q in (0.0, 0.5, 0.95, 1.0, 0.99):
        assert tm._percentile(vals, q) == ref_tm._percentile(vals, q)
    assert tm._percentile([], 0.99) == 0.0
    assert tm._percentile(vals, 0.5) == 0.3
    assert tm._percentile(vals, 0.95) == 0.5
    assert tm._percentile([7.0], 0.99) == 7.0


def test_latency_percentiles_and_class_windows():
    lat = [0.010, 0.020, 0.030, 0.040, 0.100]

    def run(mod, stats):
        for i, el in enumerate(lat):
            t0 = float(i)
            stats.record_request(_trace(mod, 5, t0, t0 + 0.001, t0 + el),
                                 slo="interactive" if i < 4 else "bulk")

    s = _both(run, window=8).summary()
    assert s["n_requests"] == 5 and s["n_points"] == 25
    assert abs(s["latency_p50_s"] - 0.030) < 1e-12
    assert abs(s["latency_p99_s"] - 0.100) < 1e-12
    assert abs(s["queue_wait_p50_s"] - 0.001) < 1e-12
    assert s["by_class"]["interactive"]["n"] == 4
    assert abs(s["by_class"]["bulk"]["latency_p99_s"] - 0.100) < 1e-12


def test_window_bounds_percentile_samples_not_counters():
    def run(mod, stats):
        for i in range(10):
            stats.record_request(_trace(mod, 1, 0.0, 0.0, float(i + 1)))

    stats = _both(run, window=4)
    s = stats.summary()
    assert s["n_requests"] == 10
    assert len(stats.latencies_s) == 4
    assert s["latency_p50_s"] >= 8.0


def test_occupancy_accumulates_ratio_terms():
    assert tm.ServerStats().summary()["padding_occupancy"] == 1.0

    def run(mod, stats):
        stats.record_occupancy(30.0, 60.0)
        stats.record_occupancy(10.0, 20.0)

    stats = _both(run)
    assert abs(stats.summary()["padding_occupancy"] - 0.5) < 1e-12
    assert (stats.true_flops, stats.padded_flops) == (40.0, 80.0)


def test_compiled_shapes_one_key_per_bucket_piece():
    def run(mod, stats):
        stats.record_chunk_shape(8, 16, 32, count_chunk=True, tier="f64")
        stats.record_chunk_shape(8, 8, 64, count_chunk=False, tier="f64")
        stats.record_chunk_shape(16, 24, 96, count_chunk=False, tier="f64")

    stats = _both(run)
    assert stats.n_chunks == 1
    assert stats.summary()["n_compiled_shapes"] == 3


def test_compiled_shapes_key_includes_precision_tier():
    def run(mod, stats):
        stats.record_chunk_shape(8, 16, 32, tier="f64")
        stats.record_chunk_shape(8, 16, 32, tier="f32")
        stats.record_chunk_shape(8, 16, 32, tier="f32")

    stats = _both(run)
    assert stats.compiled_shape_keys() == {(8, 16, 32, "f64"), (8, 16, 32, "f32")}


def test_pipeline_records_tier_tagged_keys_per_piece():
    """The port's chunk split lands one tier-tagged key per piece, read off
    the pieces' packed dtypes (bf16: a ``torch.bfloat16`` coordinate
    tensor), the same keys as the reference's split of the same chunk."""
    from repro.core.buckets import dtype_tier as ref_dtype_tier
    from repro.core.predict import build_train_index as ref_index
    from repro.core.predict import pack_queries as ref_pack
    from repro.serving.pipeline import PipelineConfig as RefConfig
    from repro.serving.pipeline import _record_pieces as ref_record
    from repro.serving.pipeline import make_chunk_split as ref_split
    from repro_torch.core.buckets import dtype_tier
    from repro_torch.core.predict import build_train_index, pack_queries
    from repro_torch.serving.pipeline import PipelineConfig, _record_pieces, make_chunk_split

    assert dtype_tier(np.float64) == "f64" and dtype_tier(np.float32) == "f32"
    assert dtype_tier(torch.bfloat16) == "bf16" == ref_dtype_tier(np.dtype("bfloat16"))
    rng = np.random.default_rng(0)
    x, y, xq = rng.uniform(size=(300, 3)), rng.normal(size=300), rng.uniform(size=(90, 3))
    beta = np.array([0.3, 0.6, 1.2])
    for precision in (None, "f32", "bf16"):
        kw = dict(bs_pred=6, m_pred=16, n_buckets=3, precision=precision)
        got, want = tm.ServerStats(), ref_tm.ServerStats()
        pk = pack_queries(build_train_index(x, y, beta, 16), xq, 6, 16, pad_shapes=True,
                          dtype=PipelineConfig(**kw).dtype)
        rpk = ref_pack(ref_index(x, y, beta, 16), xq, 6, 16, pad_shapes=True,
                       dtype=RefConfig(**kw).dtype)
        _record_pieces(got, [(p, None, None) for p in make_chunk_split(PipelineConfig(**kw))(pk)])
        ref_record(want, [(p, None, None) for p in ref_split(RefConfig(**kw))(rpk)])
        assert got.compiled_shape_keys() == want.compiled_shape_keys()
        assert got.n_chunks == want.n_chunks == 1
        assert {k[3] for k in got.compiled_shape_keys()} == {precision or "f64"}
        np.testing.assert_allclose(got.summary()["padding_occupancy"],
                                   want.summary()["padding_occupancy"], rtol=1e-15)


def test_compiled_shape_keys_returns_a_snapshot():
    stats = tm.ServerStats()
    stats.record_chunk_shape(8, 16, 32)
    snap = stats.compiled_shape_keys()
    stats.record_chunk_shape(16, 16, 32)
    assert len(snap) == 1 and len(stats.compiled_shape_keys()) == 2


def test_reset_zeroes_counters_and_windows():
    def run(mod, stats):
        stats.record_request(_trace(mod, 10, 0.0, 0.1, 0.2), slo="interactive")
        stats.record_batch(2, 20)
        stats.record_chunk_shape(8, 16, 32, tier="f32")
        stats.record_occupancy(1.0, 2.0)
        stats.record_cancelled()
        stats.record_preemption()
        stats.record_rejected()
        stats.record_queue_depth(64)
        stats.reset()

    s = _both(run).summary()
    for k in ("n_requests", "n_points", "n_batches", "n_chunks", "n_cancelled",
              "n_preempted", "n_rejected", "queue_depth_points", "queue_depth_peak"):
        assert s[k] == 0, k
    assert s["latency_p50_s"] == 0.0 and s["by_class"] == {}
    assert s["padding_occupancy"] == 1.0


def test_reset_preserves_compiled_shapes_by_default():
    def run(mod, stats):
        stats.record_chunk_shape(8, 16, 32, tier="f64")
        stats.reset()

    stats = _both(run)
    assert stats.summary()["n_compiled_shapes"] == 1
    stats.reset(preserve_shapes=False)
    assert stats.summary()["n_compiled_shapes"] == 0
