"""Port vs reference: the continuous-batching scheduler (tests/test_scheduler.py).

Everything runs on an injectable FAKE clock with scripted arrivals, no
real sleeps, as in the reference. Two layers:

* policy tests drive ``next_chunk`` / ``complete_chunk`` by hand with fake
  pieces and assert the decision sequence; the same scripts run on the
  reference's scheduler and must give the same sequence;
* ``SchedHarness`` runs the real result path (``pack_scheduled`` + the
  port's ``packed_predict``, whose device tensors ``complete_chunk``
  lands) one chunk per ``step()``, so any admission interleaving can be
  scripted.

Tolerances (tests/_torch_serving_common.py): each finished request against
its own lone port ``predict_sbv`` at atol 1e-12, and in the scripted
schedules also against the reference's lone ``predict_sbv`` at 10 eps
cond(K(NN, NN)) max(1, |mean|); the same schedules, and the threaded
server, at the well-conditioned fixture (nugget 1e-2) against the
reference's at atol 1e-12. The property test (hypothesis, at most 8
examples) holds the port's own 1e-12 contract. Bucketed continuous serving
(ROADMAP fault 7, repaired in the port): bitwise the bucketed synchronous
loop and 1e-10 from the uniform ``predict_sbv``. Every wait has a timeout.
"""
import os
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402
from _torch_serving_common import (PARITY, assert_parity, conditioned_problem,  # noqa: E402
                                   conditioning_tol, port_predict, ref_predict,
                                   synthetic_problem)
from repro.serving import BatchingPolicy as RefBatchingPolicy  # noqa: E402
from repro.serving import ContinuousScheduler as RefScheduler  # noqa: E402
from repro.serving import SchedulerPolicy as RefSchedulerPolicy  # noqa: E402
from repro.serving import ServeRequest as RefServeRequest  # noqa: E402
from repro.serving import request_chunk_bounds as ref_chunk_bounds  # noqa: E402
from repro_torch.core.predict import build_train_index, packed_predict  # noqa: E402
from repro_torch.serving import (AdmissionQueueFull, BatchingPolicy,  # noqa: E402
                                 ContinuousScheduler, GPServer, GPServerConfig,
                                 PipelineConfig, SchedulerPolicy, ServeRequest,
                                 SpoolResultSink, pack_scheduled, request_chunk_bounds)
from repro_torch.serving.telemetry import ServerStats  # noqa: E402

WAIT = 300.0


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


PORT = dict(sched=ContinuousScheduler, policy=SchedulerPolicy, window=BatchingPolicy,
            req=ServeRequest)
REF = dict(sched=RefScheduler, policy=RefSchedulerPolicy, window=RefBatchingPolicy,
           req=RefServeRequest)


def mk_req(n=4, slo="interactive", d=2, pkg=PORT):
    return pkg["req"](x=np.zeros((n, d)), future=Future(), slo=slo)


def mk_sched(clock=None, stats=None, chunk_size=4, bs_pred=2, pkg=PORT, **policy_kw):
    window = policy_kw.pop("window", pkg["window"](max_wait_s=0.0))
    return pkg["sched"](policy=pkg["policy"](**policy_kw), window=window,
                        chunk_size=chunk_size, bs_pred=bs_pred, clock=clock or FakeClock(),
                        stats=stats)


def fake_complete(sched, item):
    n = item.stop - item.start
    piece = SimpleNamespace(q_idx=np.arange(item.start, item.stop), q_mask=np.ones(n, bool))
    vals = np.arange(item.start, item.stop, dtype=float)
    sched.complete_chunk(item, piece, vals, vals + 0.5)


def picks(sched, limit=100, complete=True):
    out = []
    for _ in range(limit):
        item = sched.next_chunk()
        if item is None:
            return out
        out.append(item)
        if complete:
            fake_complete(sched, item)
    raise AssertionError("scheduler did not drain")


def _trace(items):
    return [(it.request.slo, it.ci, it.start, it.stop) for it in items]


# -- chunk protocol ----------------------------------------------------


def test_request_chunk_bounds_mirror_reference():
    for n, chunk, bs in [(10, 4, 2), (10, None, 25), (3, 4, 8), (8, 4, 2), (1, 4096, 25),
                         (50_000, 4096, 25), (8191, 4096, 25), (17, 8, 4)]:
        assert request_chunk_bounds(n, chunk, bs) == ref_chunk_bounds(n, chunk, bs)
    assert request_chunk_bounds(10, 4, 2) == [(0, 4), (4, 8), (8, 10)]


# -- admission ordering / weighted fairness ----------------------------


def test_interactive_preempts_queued_bulk_in_admission_order():
    clock = FakeClock()
    stats = ServerStats()
    sched = mk_sched(clock=clock, stats=stats)
    bulk = mk_req(12, slo="bulk")
    sched.submit(bulk)
    first = sched.next_chunk()
    assert first.request is bulk and first.ci == 0
    clock.advance(0.001)
    inter = mk_req(4, slo="interactive")
    sched.submit(inter)
    nxt = sched.next_chunk()
    assert nxt.request is inter
    assert stats.n_preempted >= 1
    fake_complete(sched, first)
    fake_complete(sched, nxt)
    rest = picks(sched)
    assert [it.request for it in rest] == [bulk, bulk]
    assert [it.ci for it in rest] == [1, 2]


@pytest.mark.parametrize("order", ["bulk_first", "interactive_first"])
def test_weighted_fair_picks_equal_reference(order):
    """Both classes backlogged: the port's pick sequence is the reference's
    (3:1 shares, every 4-pick window holds both classes)."""
    seqs = []
    for pkg in (PORT, REF):
        sched = mk_sched(pkg=pkg)
        reqs = [mk_req(9 * 4, slo="bulk", pkg=pkg), mk_req(9 * 4, slo="interactive", pkg=pkg)]
        for r in (reqs if order == "bulk_first" else reqs[::-1]):
            sched.submit(r)
        seqs.append(_trace(picks(sched, limit=30, complete=False)))
    assert seqs[0] == seqs[1]
    both = [s[0] for s in seqs[0][:12]]
    assert both.count("interactive") == 9 and both.count("bulk") == 3
    for i in range(len(both) - 3):
        assert {"bulk", "interactive"} <= set(both[i:i + 4])


def test_same_class_requests_run_fifo():
    sched = mk_sched()
    reqs = [mk_req(4) for _ in range(3)]
    for r in reqs:
        sched.submit(r)
    assert [it.request for it in picks(sched, complete=False)] == reqs


# -- cancellation ------------------------------------------------------


def test_cancellation_takes_effect_within_one_chunk():
    stats = ServerStats()
    sched = mk_sched(stats=stats)
    req = mk_req(12, slo="bulk")
    sched.submit(req)
    first = sched.next_chunk()
    assert first.ci == 0
    assert sched.cancel(req.future)
    fake_complete(sched, first)
    assert sched.next_chunk() is None
    assert req.future.cancelled()
    with pytest.raises(Exception):
        req.future.result(timeout=0)
    assert stats.n_cancelled == 1


def test_cancel_queued_request_before_admission():
    stats = ServerStats()
    sched = mk_sched(stats=stats)
    req = mk_req(4)
    sched.submit(req)
    assert sched.queue_depth_points == 4
    assert req.future.cancel()
    assert sched.next_chunk() is None
    assert sched.queue_depth_points == 0
    assert req.future.cancelled() and stats.n_cancelled == 1


def test_cancel_unknown_or_finished_future_is_refused():
    sched = mk_sched()
    assert not sched.cancel(Future())
    req = mk_req(4)
    sched.submit(req)
    picks(sched)
    mean, var = req.future.result(timeout=0)
    assert not sched.cancel(req.future)
    np.testing.assert_array_equal(mean, np.arange(4.0))
    np.testing.assert_array_equal(var, np.arange(4.0) + 0.5)


# -- backpressure ------------------------------------------------------


def test_bounded_admission_queue_raises_and_recovers():
    stats = ServerStats()
    sched = mk_sched(stats=stats, queue_bound=10)
    sched.submit(mk_req(8))
    with pytest.raises(AdmissionQueueFull):
        sched.submit(mk_req(4))
    assert stats.n_rejected == 1
    sched.submit(mk_req(2))
    assert sched.next_chunk() is not None
    assert sched.queue_depth_points == 0
    sched.submit(mk_req(10))
    assert stats.queue_depth_peak == 10


def test_max_active_requests_caps_running_batch():
    sched = mk_sched(max_active_requests=2)
    reqs = [mk_req(8) for _ in range(4)]
    for r in reqs:
        sched.submit(r)
    first = sched.next_chunk()
    assert first.request is reqs[0]
    assert sched.queue_depth_points == 16
    fake_complete(sched, first)
    picks(sched)
    assert all(r.future.done() for r in reqs)


# -- adaptive window interaction ---------------------------------------


def test_idle_window_defers_admission_until_close_or_trip():
    clock = FakeClock()
    window = BatchingPolicy(max_points=100, max_wait_s=0.010)
    sched = mk_sched(clock=clock, window=window)
    sched.submit(mk_req(4))
    assert sched.next_chunk() is None
    clock.advance(0.005)
    assert sched.next_chunk() is None
    clock.advance(0.006)
    assert sched.next_chunk() is not None
    sched2 = mk_sched(clock=FakeClock(), window=window)
    sched2.submit(mk_req(4))
    assert sched2.next_chunk() is None
    sched2.flush()
    assert sched2.next_chunk() is not None
    sched3 = mk_sched(clock=FakeClock(), window=BatchingPolicy(max_points=8, max_wait_s=30.0))
    sched3.submit(mk_req(8))
    assert sched3.next_chunk() is not None


def test_busy_device_admits_immediately_despite_window():
    clock = FakeClock()
    sched = mk_sched(clock=clock, window=BatchingPolicy(max_points=100, max_wait_s=30.0))
    bulk = mk_req(8, slo="bulk")
    sched.submit(bulk)
    sched.flush()
    assert sched.next_chunk().request is bulk
    inter = mk_req(4, slo="interactive")
    sched.submit(inter)
    assert sched.next_chunk().request is inter


def test_adaptive_window_shrinks_with_dense_arrivals():
    clock = FakeClock()
    window = BatchingPolicy(max_points=10_000, max_wait_s=0.010, adaptive=True,
                            window_factor=2.0, ema_alpha=1.0)
    sched = mk_sched(clock=clock, window=window)
    for _ in range(4):
        sched.submit(mk_req(1))
        clock.advance(0.001)
    assert sched.next_chunk() is None
    clock.advance(0.0015)
    assert sched.next_chunk() is not None


# -- the parity contract (real compute, scripted schedules) ------------


def _problem(make):
    x, y, ref_params, params = make(seed=0, n=80, d=3)
    cfg = PipelineConfig(bs_pred=4, m_pred=16, chunk_size=8)
    index = build_train_index(x, y, params.beta.numpy(), cfg.m_pred, seed=11)
    return params, ref_params, x, y, index, cfg


@pytest.fixture(scope="module")
def problem():
    return _problem(synthetic_problem)


@pytest.fixture(scope="module")
def conditioned():
    return _problem(conditioned_problem)


class SchedHarness:
    """Scripted arrivals over the real result path: one chunk of real
    pack + predict per ``step()``, single-threaded, fake-clocked. The
    conditionals are device tensors (``packed_predict``) that
    ``complete_chunk`` lands."""

    def __init__(self, problem, seed=11, ref_tol=None, **policy_kw):
        self.params, self.ref_params, self.x, self.y, self.index, self.cfg = problem
        self.seed = seed
        self.ref_tol = ref_tol  # None: conditioning_tol of each request
        self.clock = FakeClock()
        self.stats = ServerStats()
        window = policy_kw.pop("window", BatchingPolicy(max_wait_s=0.0))
        self.sched = ContinuousScheduler(policy=SchedulerPolicy(**policy_kw), window=window,
                                         chunk_size=self.cfg.chunk_size,
                                         bs_pred=self.cfg.bs_pred, clock=self.clock,
                                         stats=self.stats)

    def submit(self, xq, slo="interactive"):
        req = ServeRequest(x=np.asarray(xq, dtype=np.float64), future=Future(), slo=slo)
        self.sched.submit(req)
        return req.future

    def step(self) -> bool:
        item = self.sched.next_chunk()
        if item is None:
            return False
        packed = pack_scheduled(self.index, self.cfg, item, seed=self.seed)
        mu, var = packed_predict(self.params, packed, nu=self.cfg.nu,
                                 backend=self.cfg.backend, device="cpu")
        assert isinstance(mu, torch.Tensor)
        self.sched.complete_chunk(item, packed, mu, var)
        return True

    def drain(self):
        self.sched.close()
        while self.step():
            pass

    def result(self, fut):
        result = fut.result(timeout=0)
        return result.materialize() if isinstance(result, SpoolResultSink) else result

    def assert_matches_port(self, fut, xq):
        c = self.cfg
        mean, var = self.result(fut)
        assert_parity(mean, var, port_predict(self.params, self.x, self.y, xq, c.bs_pred,
                                              c.m_pred, self.seed, c.chunk_size), PARITY)
        return mean, var

    def assert_matches_reference(self, fut, xq):
        c = self.cfg
        mean, var = self.assert_matches_port(fut, xq)
        tol = self.ref_tol or conditioning_tol(self.params, self.x, self.y, xq, c.bs_pred,
                                               c.m_pred, self.seed, c.chunk_size)
        assert_parity(mean, var, ref_predict(self.ref_params, self.x, self.y, xq, c.bs_pred,
                                             c.m_pred, self.seed, c.chunk_size), tol)


def _admission(problem, tmp_path, ref_tol=None):
    rng = np.random.default_rng(42)
    h = SchedHarness(problem, ref_tol=ref_tol)
    xs, futs = [], []

    def add(n, slo):
        xq = rng.uniform(size=(n, 3))
        xs.append(xq)
        futs.append(h.submit(xq, slo=slo))

    add(20, "bulk")
    assert h.step()
    add(3, "interactive")
    assert h.step()
    add(17, "bulk")
    add(1, "interactive")
    h.drain()
    for fut, xq in zip(futs, xs):
        h.assert_matches_reference(fut, xq)
    by_class = h.stats.summary()["by_class"]
    assert by_class["interactive"]["n"] == 2 and by_class["bulk"]["n"] == 2


def _cancellation(problem, tmp_path, ref_tol=None):
    rng = np.random.default_rng(43)
    h = SchedHarness(problem, ref_tol=ref_tol)
    x_keep, x_dead = rng.uniform(size=(12, 3)), rng.uniform(size=(20, 3))
    fut_keep = h.submit(x_keep, slo="interactive")
    fut_dead = h.submit(x_dead, slo="bulk")
    assert h.step()
    h.sched.cancel(fut_dead)
    h.drain()
    assert fut_dead.cancelled()
    h.assert_matches_reference(fut_keep, x_keep)


def _spool(problem, tmp_path, ref_tol=None):
    rng = np.random.default_rng(44)
    h = SchedHarness(problem, spool_threshold=16, spool_dir=str(tmp_path), ref_tol=ref_tol)
    x_small, x_big = rng.uniform(size=(6, 3)), rng.uniform(size=(30, 3))
    fut_small = h.submit(x_small, slo="interactive")
    fut_big = h.submit(x_big, slo="bulk")
    h.drain()
    if ref_tol is None:
        h.assert_matches_port(fut_small, x_small)
    else:
        h.assert_matches_reference(fut_small, x_small)
    sink = fut_big.result(timeout=0)
    assert isinstance(sink, SpoolResultSink)
    assert sink.n_chunks == 4 and sink.spooled_bytes > 0
    seen = np.concatenate([idx for idx, _, _ in sink.iter_chunks()])
    np.testing.assert_array_equal(np.sort(seen), np.arange(30))
    h.assert_matches_reference(fut_big, x_big)
    assert os.listdir(str(tmp_path) + "/req_000001")
    sink.cleanup()
    assert not os.path.exists(str(tmp_path) + "/req_000001")


def test_mid_stream_admission_preserves_per_request_parity(problem, tmp_path):
    _admission(problem, tmp_path)


def test_cancellation_mid_stream_leaves_others_exact(problem, tmp_path):
    _cancellation(problem, tmp_path)


def test_spool_sink_result_roundtrips_exactly(problem, tmp_path):
    _spool(problem, tmp_path)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=8, deadline=None)
@given(
    sizes=st.lists(st.integers(min_value=1, max_value=18), min_size=1, max_size=4),
    slos=st.lists(st.sampled_from(["interactive", "bulk"]), min_size=4, max_size=4),
    ops=st.lists(st.tuples(st.sampled_from(["step", "submit", "cancel", "flush"]),
                           st.integers(min_value=0, max_value=3)), max_size=20),
    data_seed=st.integers(min_value=0, max_value=2**16),
)
def test_random_interleavings_match_lone_predict(problem, sizes, slos, ops, data_seed):
    """For ANY interleaving of submit / cancel / flush / step, every
    request not cancelled equals its own lone ``predict_sbv`` and every
    future resolves exactly once."""
    rng = np.random.default_rng(data_seed)
    h = SchedHarness(problem)
    xs = [rng.uniform(size=(n, 3)) for n in sizes]
    futs = [None] * len(xs)
    next_submit = 0
    cancelled = set()

    def do_submit():
        nonlocal next_submit
        if next_submit < len(xs):
            futs[next_submit] = h.submit(xs[next_submit], slo=slos[next_submit % len(slos)])
            next_submit += 1

    do_submit()
    for op, k in ops:
        if op == "submit":
            do_submit()
        elif op == "step":
            h.step()
        elif op == "flush":
            h.sched.flush()
        elif op == "cancel" and k < next_submit:
            if h.sched.cancel(futs[k]):
                cancelled.add(k)
        h.clock.advance(0.001)
    while next_submit < len(xs):
        do_submit()
    h.drain()
    for i, (fut, xq) in enumerate(zip(futs, xs)):
        assert fut.done()
        if fut.cancelled():
            assert i in cancelled
        else:
            h.assert_matches_port(fut, xq)


# -- threaded end-to-end (GPServer in scheduler mode) ------------------


def _server_end_to_end(problem, tmp_path, ref_tol=None):
    params, ref_params, x, y, _, cfg = problem
    rng = np.random.default_rng(45)
    config = GPServerConfig(pipeline=cfg,
                            policy=BatchingPolicy(max_points=4096, max_wait_s=0.002),
                            scheduler=SchedulerPolicy(spool_threshold=64, queue_bound=100_000),
                            seed=11)
    server = GPServer(params, x, y, config, device="cpu")
    reqs = [(rng.uniform(size=(n, 3)), slo)
            for n, slo in [(5, "interactive"), (70, "bulk"), (2, "interactive"),
                           (12, "interactive")]]
    with server:
        futs = [server.submit(xq, slo=slo) for xq, slo in reqs]
        victim = server.submit(rng.uniform(size=(40, 3)), slo="bulk")
        assert server.cancel(victim)
        server.flush()
        results = [f.result(timeout=WAIT) for f in futs]
    assert victim.cancelled()
    for (xq, _slo), res in zip(reqs, results):
        if res.sink is not None:
            mean, var = res.sink.materialize()
            res.sink.cleanup()
        else:
            mean, var = res.mean, res.var
        assert_parity(mean, var, port_predict(params, x, y, xq, cfg.bs_pred, cfg.m_pred, 11,
                                              cfg.chunk_size), PARITY)
        if ref_tol is not None:
            assert_parity(mean, var, ref_predict(ref_params, x, y, xq, cfg.bs_pred, cfg.m_pred,
                                                 11, cfg.chunk_size), ref_tol)
    summary = server.stats.summary()
    assert summary["n_cancelled"] == 1
    assert summary["by_class"]["interactive"]["n"] == 3
    assert summary["by_class"]["bulk"]["n"] == 1
    assert summary["by_class"]["interactive"]["latency_p99_s"] > 0


def test_server_continuous_mode_end_to_end(problem, tmp_path):
    """Real threads, real clock: a mixed SLO workload with a spooled bulk
    sweep and a cancellation; every finished request equals its lone
    ``predict_sbv``."""
    _server_end_to_end(problem, tmp_path)


@pytest.mark.parametrize("scenario", [_admission, _cancellation, _spool, _server_end_to_end],
                         ids=["admission", "cancellation", "spool", "server"])
def test_well_conditioned_schedules_match_reference(conditioned, scenario, tmp_path):
    """The scripted schedules and the threaded server at nugget 1e-2: every
    finished request within 1e-12 of the reference's lone ``predict_sbv``."""
    scenario(conditioned, tmp_path, ref_tol=PARITY)


def test_bucketed_continuous_serving_lands_every_piece(problem):
    """ROADMAP fault 7: a bucketed chunk lands as several pieces; the
    reference's ``complete_chunk`` counts pieces as chunks and resolves the
    request before its later pieces land (rows left at 0). The port counts
    landed rows: every request equals the bucketed synchronous loop on it
    alone, bitwise, and the uniform lone ``predict_sbv`` within 1e-10
    (bucketed = uniform, docs/packing.md)."""
    from repro.core.predict import build_train_index as ref_build_index
    from repro.serving import GPServer as RefServer
    from repro.serving import GPServerConfig as RefServerConfig
    from repro.serving import PipelineConfig as RefPipelineConfig
    from repro_torch.serving import predict_synchronous

    params, ref_params, x, y, index, _ = problem
    cfg = PipelineConfig(bs_pred=4, m_pred=16, chunk_size=24, n_buckets=3)
    rng = np.random.default_rng(46)
    xs = [rng.uniform(size=(n, 3)) for n in (30, 7, 49)]
    conf = GPServerConfig(pipeline=cfg, policy=BatchingPolicy(max_wait_s=0.002),
                          scheduler=SchedulerPolicy(), seed=11)
    with GPServer(params, x, y, conf, index=index, device="cpu") as server:
        futs = [server.submit(xq) for xq in xs]
        server.flush()
        results = [f.result(timeout=WAIT) for f in futs]
    for xq, res in zip(xs, results):
        want = predict_synchronous(params, index, xq, cfg, seed=11, device="cpu")
        np.testing.assert_array_equal(res.mean, want[0])
        np.testing.assert_array_equal(res.var, want[1])
        assert_parity(res.mean, res.var, port_predict(params, x, y, xq, 4, 16, 11, 24), 1e-10)
        assert np.all(res.var > 0)
    ref_conf = RefServerConfig(pipeline=RefPipelineConfig(bs_pred=4, m_pred=16, chunk_size=24,
                                                          n_buckets=3),
                               policy=RefBatchingPolicy(max_wait_s=0.002),
                               scheduler=RefSchedulerPolicy(), seed=11)
    ref_index = ref_build_index(x, y, np.asarray(ref_params.beta), 16, seed=11)
    with RefServer(ref_params, x, y, ref_conf, index=ref_index) as ref_server:
        fut = ref_server.submit(xs[2])
        ref_server.flush()
        ref_res = fut.result(timeout=WAIT)
    assert np.any(np.asarray(ref_res.var) == 0.0)  # the reference's unlanded rows
