"""Port vs reference: the persistent GP server and the chunk pipeline
(tests/test_serving.py's cases, on the CPU, f64).

Tolerances (see tests/_torch_serving_common.py):
- served requests against the port's own lone ``predict_sbv`` on the same
  inputs: atol 1e-12 (coalescing is concatenation; the reference's serving
  contract);
- against the reference's ``predict_sbv`` / ``predict_synchronous`` on the
  same inputs: 10 eps cond(K(NN, NN)) max(1, |mean|) (2.3e-11 measured at
  the 400-point fixture, whose nugget is 1e-8);
- at the well-conditioned fixture (nugget 1e-2), the served requests and
  the pipelined and synchronous chunk loops against the reference's
  ``predict_sbv``: atol 1e-12;
- the pipelined chunk loop against the synchronous one: bitwise;
- bucketed against uniform serving: 1e-10 (docs/packing.md);
- the multi-output server (the reference fixture of
  tests/test_multioutput.py, tau2 = 1e-3): masked columns bitwise the
  port's ``predict_sbv`` and within rtol 1e-10 / atol 1e-12 of the
  reference's, as tests/test_torch_multioutput.py holds the prediction;
- exact-GP answers at m_pred >= n_train: 1e-4 (the reference's bound);
- chunks sharded over a 2-worker CPU mesh: 1e-12 from one device.
Every wait has its own timeout.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_serving_common import (PARITY, assert_parity, conditioned_problem,  # noqa: E402
                                   conditioning_tol, port_predict, ref_predict,
                                   synthetic_problem)
from repro.core import exact_predict as ref_exact_predict  # noqa: E402
from repro.core import packed_predict as ref_packed_predict  # noqa: E402
from repro.core.predict import build_train_index as ref_build_index  # noqa: E402
from repro.serving import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.serving import predict_synchronous as ref_predict_synchronous  # noqa: E402
from repro_torch.core import exact_predict  # noqa: E402
from repro_torch.core.predict import build_train_index, pack_queries, packed_predict  # noqa: E402
from repro_torch.serving import (BatchingPolicy, ChunkTimer, GPServer,  # noqa: E402
                                 GPServerConfig, PipelineConfig, SchedulerPolicy,
                                 predict_pipelined, predict_synchronous)
from repro_torch.serving.batching import MicroBatcher, PredictRequest  # noqa: E402
from repro_torch.serving.telemetry import ServerStats  # noqa: E402

WAIT = 120.0  # seconds any one future may take


@pytest.fixture(scope="module")
def problem():
    x, y, ref_params, params = synthetic_problem(seed=0, n=400, d=4)
    rng = np.random.default_rng(7)
    requests = [rng.uniform(size=(n, 4)) for n in (33, 5, 80, 1, 41)]
    return params, ref_params, x, y, requests


def test_microbatched_requests_match_single_predict_sbv(problem):
    params, ref_params, x, y, requests = problem
    concat = np.concatenate(requests, axis=0)
    cfg = GPServerConfig(pipeline=PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64),
                         policy=BatchingPolicy(max_points=100_000, max_wait_s=30.0), seed=3)
    server = GPServer(params, x, y, cfg, device="cpu")
    with server:
        futs = [server.submit(r) for r in requests]
        server.flush()  # everything queued -> ONE micro-batch
        results = [f.result(timeout=WAIT) for f in futs]
    mean = np.concatenate([r.mean for r in results])
    var = np.concatenate([r.var for r in results])
    assert_parity(mean, var, port_predict(params, x, y, concat, 8, 32, 3, 64), PARITY)
    tol = conditioning_tol(params, x, y, concat, 8, 32, 3, 64)
    assert_parity(mean, var, ref_predict(ref_params, x, y, concat, 8, 32, 3, 64), tol)
    stats = server.stats.summary()
    assert stats["n_batches"] == 1
    assert stats["n_requests"] == len(requests)
    assert stats["n_points"] == concat.shape[0]


@pytest.fixture(scope="module")
def conditioned():
    x, y, ref_params, params = conditioned_problem(seed=0, n=400, d=4)
    requests = [np.random.default_rng(7).uniform(size=(n, 4)) for n in (33, 5, 80, 1, 41)]
    concat = np.concatenate(requests, axis=0)
    want = ref_predict(ref_params, x, y, concat, 8, 32, 3, 64)
    return params, x, y, requests, want


@pytest.mark.parametrize("loop", ["served", "pipelined", "synchronous"])
def test_well_conditioned_results_match_reference(conditioned, loop):
    """At nugget 1e-2 the served requests and both chunk loops equal the
    reference's ``predict_sbv`` on the concatenation within 1e-12."""
    params, x, y, requests, want = conditioned
    pipe = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64)
    if loop == "served":
        cfg = GPServerConfig(pipeline=pipe, seed=3,
                             policy=BatchingPolicy(max_points=100_000, max_wait_s=30.0))
        with GPServer(params, x, y, cfg, device="cpu") as server:
            futs = [server.submit(r) for r in requests]
            server.flush()
            results = [f.result(timeout=WAIT) for f in futs]
        assert server.stats.summary()["n_batches"] == 1
        mean = np.concatenate([r.mean for r in results])
        var = np.concatenate([r.var for r in results])
    else:
        runner = predict_pipelined if loop == "pipelined" else predict_synchronous
        index = build_train_index(x, y, params.beta.numpy(), 32, seed=3)
        mean, var = runner(params, index, np.concatenate(requests, axis=0), pipe, seed=3,
                           device="cpu")
    assert_parity(mean, var, want, PARITY)


def test_pipelined_equals_synchronous(problem):
    """Bitwise to the synchronous loop, and both against the reference's
    synchronous loop on the reference's own index."""
    params, ref_params, x, y, requests = problem
    xt = np.concatenate(requests, axis=0)
    index = build_train_index(x, y, params.beta.numpy(), 32, seed=1)
    cfg = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=48)
    timer = ChunkTimer()
    m_sync, v_sync = predict_synchronous(params, index, xt, cfg, seed=1, device="cpu")
    m_pipe, v_pipe = predict_pipelined(params, index, xt, cfg, seed=1, device="cpu",
                                       timer=timer)
    np.testing.assert_array_equal(m_pipe, m_sync)
    np.testing.assert_array_equal(v_pipe, v_sync)
    s = timer.summary()
    assert s["n_chunks"] == 4 and s["pack_s"] > 0 and s["compute_s"] > 0
    ref_index = ref_build_index(x, y, np.asarray(ref_params.beta), 32, seed=1)
    want = ref_predict_synchronous(ref_params, ref_index, xt,
                                   RefPipelineConfig(bs_pred=8, m_pred=32, chunk_size=48),
                                   seed=1)
    tol = conditioning_tol(params, x, y, xt, 8, 32, 1, 48)
    assert_parity(m_pipe, v_pipe, want, tol)


def test_packed_predict_returns_device_tensors_matching_reference(problem):
    """``packed_predict`` (the reference's entry of the per-chunk compute)
    returns the conditionals as tensors on the device; both routes agree
    with the reference's ``ref`` program on the reference's packed chunk."""
    params, ref_params, x, y, requests = problem
    xt = np.concatenate(requests, axis=0)
    index = ref_build_index(x, y, np.asarray(ref_params.beta), 24, seed=2)
    from repro.core.predict import pack_queries as ref_pack_queries

    packed = ref_pack_queries(index, xt, bs_pred=8, m_pred=24, seed=2)
    mu_r, var_r = (np.asarray(a) for a in ref_packed_predict(ref_params, packed, backend="ref"))
    port_packed = pack_queries(build_train_index(x, y, params.beta.numpy(), 24, seed=2), xt,
                               bs_pred=8, m_pred=24, seed=2)
    for f in ("q_x", "q_mask", "q_idx", "nn_x", "nn_y", "nn_mask"):
        np.testing.assert_array_equal(getattr(port_packed, f), getattr(packed, f))
    tol = conditioning_tol(params, x, y, xt, 8, 24, 2, None)
    msk = packed.q_mask
    outs = {}
    for backend in ("auto", "ref"):
        mu, var = packed_predict(params, port_packed, backend=backend, device="cpu")
        assert isinstance(mu, torch.Tensor) and mu.shape == packed.q_mask.shape
        np.testing.assert_allclose(mu.numpy()[msk], mu_r[msk], rtol=0, atol=tol)
        np.testing.assert_allclose(var.numpy()[msk], var_r[msk], rtol=0, atol=tol)
        outs[backend] = (mu, var)
    for a, b in zip(outs["auto"], outs["ref"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARITY)


def test_max_points_policy_splits_batches_and_stays_exact():
    """Oversized windows split into several micro-batches; every request
    still matches the exact GP (m_pred >= n_train: the block conditional
    IS the exact one), the port's and the reference's."""
    x, y, ref_params, params = synthetic_problem(seed=4, n=60, d=3)
    rng = np.random.default_rng(5)
    requests = [rng.uniform(size=(n, 3)) for n in (20, 20, 20, 20)]
    cfg = GPServerConfig(pipeline=PipelineConfig(bs_pred=8, m_pred=80, chunk_size=None),
                         policy=BatchingPolicy(max_points=40, max_wait_s=30.0), seed=4)
    server = GPServer(params, x, y, cfg, device="cpu")
    with server:
        futs = [server.submit(r) for r in requests]
        server.flush()
        results = [f.result(timeout=WAIT) for f in futs]
    assert server.stats.summary()["n_batches"] >= 2
    for req, res in zip(requests, results):
        em, ev = ref_exact_predict(ref_params, x, y, req)
        np.testing.assert_allclose(res.mean, np.asarray(em), atol=1e-4, rtol=0)
        np.testing.assert_allclose(res.var, np.asarray(ev), atol=1e-4, rtol=0)
        pm, pv = exact_predict(params, x, y, req, device="cpu")
        np.testing.assert_allclose(res.mean, pm.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(res.var, pv.numpy(), atol=1e-4, rtol=0)


def test_stop_timeout_fails_queued_futures():
    """stop() fails every still-queued future BEFORE its TimeoutError, so no
    client blocks on a request the wedged dispatcher will never pick up."""
    x, y, _, params = synthetic_problem(seed=9, n=40, d=2)
    cfg = GPServerConfig(pipeline=PipelineConfig(bs_pred=4, m_pred=16, chunk_size=None),
                         policy=BatchingPolicy(max_points=1, max_wait_s=30.0), seed=9)
    server = GPServer(params, x, y, cfg, device="cpu")
    entered, release = threading.Event(), threading.Event()

    def wedged_process(batch):
        entered.set()
        release.wait(timeout=60.0)
        for req in batch:
            if req.future.set_running_or_notify_cancel():
                req.future.set_result("late")

    server._process = wedged_process
    server.start()
    rng = np.random.default_rng(0)
    fut1 = server.submit(rng.uniform(size=(2, 2)))
    assert entered.wait(timeout=30.0)
    fut2 = server.submit(rng.uniform(size=(2, 2)))
    with pytest.raises(TimeoutError):
        server.stop(timeout_s=0.2)
    with pytest.raises(RuntimeError, match="timed out"):
        fut2.result(timeout=5.0)
    release.set()
    server.stop(timeout_s=60.0)
    assert fut1.result(timeout=5.0) == "late"


def test_latency_smoke_and_telemetry(problem):
    params, _, x, y, requests = problem
    cfg = GPServerConfig(pipeline=PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64),
                         policy=BatchingPolicy(max_points=4096, max_wait_s=0.005), seed=6)
    server = GPServer(params, x, y, cfg, device="cpu")
    with server:
        server.warmup()
        res = server.predict(requests[0], timeout_s=60.0)
    assert res.latency_s < 60.0
    assert res.queue_wait_s <= res.latency_s
    assert np.all(np.isfinite(res.mean)) and np.all(res.var > 0)
    stats = server.stats.summary()
    assert stats["n_requests"] == 2  # warmup + request
    assert stats["n_compiled_shapes"] >= 1
    assert stats["latency_p95_s"] > 0


def test_adaptive_window_scales_with_interarrival_ema():
    """The fake-clock check of the adaptive batching window, on the port's
    ``MicroBatcher``."""
    t = [0.0]
    clock = lambda: t[0]
    mk = lambda: PredictRequest(x=np.zeros((1, 2)), future=Future())
    pol = BatchingPolicy(max_wait_s=0.010, adaptive=True, window_factor=4.0, ema_alpha=0.5)
    b = MicroBatcher(pol, clock=clock)
    assert b.effective_wait_s() == pytest.approx(0.010)
    b.put(mk())
    assert b.effective_wait_s() == pytest.approx(0.010)
    for _ in range(6):
        t[0] += 0.001
        b.put(mk())
    assert b.effective_wait_s() == pytest.approx(0.004, rel=1e-6)
    t[0] += 1.0
    b.put(mk())
    assert b.effective_wait_s() == pytest.approx(0.010)
    b2 = MicroBatcher(pol, clock=clock)
    b2.put(mk())
    t[0] += 0.002
    b2.put(mk())
    t[0] += 0.004
    b2.put(mk())
    assert b2.effective_wait_s() == pytest.approx(0.010)
    assert b2._ema_gap_s == pytest.approx(0.003)
    b3 = MicroBatcher(BatchingPolicy(max_wait_s=0.010, adaptive=False), clock=clock)
    for _ in range(5):
        t[0] += 0.0001
        b3.put(mk())
    assert b3.effective_wait_s() == pytest.approx(0.010)


def test_adaptive_deadline_drives_next_batch():
    t = [0.0]
    b = MicroBatcher(BatchingPolicy(max_points=10_000, max_wait_s=30.0, adaptive=True,
                                    window_factor=2.0, ema_alpha=1.0), clock=lambda: t[0])
    for _ in range(3):
        b.put(PredictRequest(x=np.zeros((1, 2)), future=Future()))
        t[0] += 0.001
    assert b.effective_wait_s() == pytest.approx(0.002)
    t[0] += 1.0
    t0 = time.monotonic()
    batch = b.next_batch()
    assert len(batch) == 3
    assert time.monotonic() - t0 < 5.0


def test_bucketed_serving_matches_uniform(problem):
    """Bucketed micro-batches reproduce the uniform path to 1e-10, the
    pipelined bucketed loop is bitwise the synchronous one, and the padding
    occupancy equals the reference's on the same chunks."""
    params, ref_params, x, y, requests = problem
    index = build_train_index(x, y, params.beta.numpy(), 32, seed=0)
    xt = np.concatenate(requests, axis=0)
    cfg_u = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64)
    cfg_b = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64, n_buckets=4)
    stats = ServerStats()
    m_u, v_u = predict_synchronous(params, index, xt, cfg_u, seed=0, device="cpu")
    m_b, v_b = predict_synchronous(params, index, xt, cfg_b, seed=0, stats=stats, device="cpu")
    np.testing.assert_allclose(m_b, m_u, atol=1e-10, rtol=0)
    np.testing.assert_allclose(v_b, v_u, atol=1e-10, rtol=0)
    m_p, v_p = predict_pipelined(params, index, xt, cfg_b, seed=0, device="cpu")
    assert np.array_equal(m_p, m_b) and np.array_equal(v_p, v_b)
    occ = stats.summary()["padding_occupancy"]
    assert 0.0 < occ <= 1.0
    from repro.serving.telemetry import ServerStats as RefStats

    ref_stats = RefStats()
    ref_index = ref_build_index(x, y, np.asarray(ref_params.beta), 32, seed=0)
    ref_predict_synchronous(ref_params, ref_index, xt,
                            RefPipelineConfig(bs_pred=8, m_pred=32, chunk_size=64, n_buckets=4),
                            seed=0, stats=ref_stats)
    assert stats.compiled_shape_keys() == ref_stats.compiled_shape_keys()
    np.testing.assert_allclose(occ, ref_stats.summary()["padding_occupancy"], rtol=1e-14)


def test_multi_output_server_and_output_masks():
    """The reference fixture of tests/test_multioutput.py: drain and
    scheduler modes give the requested columns of ``predict_sbv``; a full
    mask is the unmasked result; bad masks are refused."""
    from repro.core import multioutput as ref_mo
    from repro_torch.convert import multi_params_from_reference

    rng = np.random.default_rng(0)
    n, d, p = 500, 3, 3
    x = rng.uniform(size=(n, d))
    y = np.stack([np.sin(x @ rng.uniform(1.0, 3.0, size=d)) + 0.01 * rng.standard_normal(n)
                  for _ in range(p)], axis=1)
    ref_p = ref_mo.MultiOutputParams.create(sigma2=[0.4, 0.7, 1.3], beta=[0.3, 0.5, 0.9],
                                            tau2=1e-3, d=d, p=p)
    params = multi_params_from_reference(*(np.asarray(a) for a in ref_p))
    xq = np.random.default_rng(11).uniform(size=(45, d))
    mine = port_predict(params, x, y, xq, 8, 24, 0, None)
    want = ref_predict(ref_p, x, y, xq, 8, 24, 0, None)
    for a, b in zip(mine, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)

    pipe = PipelineConfig(bs_pred=8, m_pred=24, chunk_size=None)
    with GPServer(params, x, y, GPServerConfig(pipeline=pipe), device="cpu") as srv:
        assert srv.n_outputs == p
        fut = srv.submit(xq, outputs=[p - 1, 0])
        srv.flush()
        res = fut.result(timeout=WAIT)
    assert res.mean.shape == (45, 2)
    np.testing.assert_array_equal(res.mean, mine[0][:, [p - 1, 0]])
    np.testing.assert_array_equal(res.var, mine[1][:, [p - 1, 0]])

    cfg = GPServerConfig(pipeline=pipe, scheduler=SchedulerPolicy())
    with GPServer(params, x, y, cfg, device="cpu") as srv:
        fut = srv.submit(xq, outputs=[1])
        srv.flush()
        r1 = fut.result(timeout=WAIT)
        fut = srv.submit(xq, outputs=list(range(p)))
        srv.flush()
        r2 = fut.result(timeout=WAIT)
    np.testing.assert_array_equal(r1.mean, mine[0][:, [1]])
    np.testing.assert_array_equal(r2.mean, mine[0])

    with GPServer(params, x, y, GPServerConfig(pipeline=pipe), device="cpu") as srv:
        with pytest.raises(ValueError):
            srv.submit(xq, outputs=[p])
        with pytest.raises(ValueError):
            srv.submit(xq, outputs=[])


def test_server_needs_a_device_without_cuda(problem, monkeypatch):
    """No quiet CPU fallback: without a CUDA device and without ``device``,
    the server, the pipelines and ``packed_predict`` raise."""
    params, _, x, y, requests = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPServer(params, x, y, GPServerConfig(pipeline=PipelineConfig(bs_pred=8, m_pred=32)))
    index = build_train_index(x, y, params.beta.numpy(), 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_synchronous(params, index, requests[0], PipelineConfig(bs_pred=8, m_pred=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_predict(params, pack_queries(index, requests[0], 8, 32))


def test_worker_mesh_serving_matches_single_device(problem):
    """``--workers k``: every chunk's blocks sharded over a worker mesh (two
    CPU workers here) give the single-device loop's results, in the
    synchronous and the pipelined loop."""
    from repro_torch.launch.mesh import make_worker_mesh

    params, _, x, y, requests = problem
    xt = np.concatenate(requests, axis=0)
    index = build_train_index(x, y, params.beta.numpy(), 32, seed=1)
    cfg = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=48)
    want = predict_synchronous(params, index, xt, cfg, seed=1, device="cpu")
    mesh = make_worker_mesh(2, devices="cpu")
    for runner in (predict_synchronous, predict_pipelined):
        got = runner(params, index, xt, cfg, seed=1, mesh=mesh)
        assert_parity(got[0], got[1], want, PARITY)
