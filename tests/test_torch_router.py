"""Port vs reference: the multi-replica router (tests/test_router.py).

- ``rendezvous_rank`` and ``request_shape_signature``: equal to the
  reference's values (keyed blake2b; the same chunk stepping and block
  rounding) over grids of signatures, replica counts, salts and configs.
- Routing never changes a result: under every policy each request equals
  its own lone port ``predict_sbv`` at atol 1e-12, and the reference's at
  10 eps cond(K(NN, NN)) max(1, |mean|) (tests/_torch_serving_common.py);
  at the well-conditioned fixture (nugget 1e-2), the reference's at atol
  1e-12.
- The two-rank serve (``python -m repro_torch.launch.serve gp
  --distributed-hosts 2 --device cpu``, gloo, 120 s per rank): every
  request served once, each rank's served parity within 1e-12, the
  multi-host prediction's mean and variance bitwise serial and its
  simulation columns within 1e-8 (the reference's gate is 1e-8 on all).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_serving_common import (PARITY, assert_parity, conditioned_problem,  # noqa: E402
                                   conditioning_tol, port_predict, ref_predict,
                                   synthetic_problem)
from repro.serving import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.serving import rendezvous_rank as ref_rendezvous_rank  # noqa: E402
from repro.serving import request_shape_signature as ref_signature  # noqa: E402
from repro_torch.serving import (AdmissionQueueFull, BatchingPolicy, GPServer,  # noqa: E402
                                 GPServerConfig, PipelineConfig, ReplicaRouter,
                                 SchedulerPolicy, rendezvous_rank, request_shape_signature)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 300.0
RANK_TIMEOUT = 120  # each rank, its rendezvous and its collectives
RUN_TIMEOUT = 240   # the launcher subprocess as a whole


@pytest.fixture(scope="module")
def problem():
    x, y, ref_params, params = synthetic_problem(seed=0, n=400, d=4)
    return params, ref_params, x, y


def _server_cfg(seed=3, queue_bound=None, **pipe_kw):
    pipe_kw.setdefault("bs_pred", 8)
    pipe_kw.setdefault("m_pred", 32)
    pipe_kw.setdefault("chunk_size", 64)
    return GPServerConfig(pipeline=PipelineConfig(**pipe_kw),
                          policy=BatchingPolicy(max_points=100_000, max_wait_s=30.0),
                          scheduler=SchedulerPolicy(queue_bound=queue_bound), seed=seed)


def _make_replicas(problem, n, cfg=None):
    params, _, x, y = problem
    cfg = cfg or _server_cfg()
    reps = [GPServer(params, x, y, cfg, device="cpu")]
    reps += [GPServer(params, x, y, cfg, index=reps[0].index, device="cpu")
             for _ in range(n - 1)]
    return reps


# -- rendezvous hashing and signatures, against the reference ---------------


def test_rendezvous_equals_reference():
    sigs = [((bc, 8, 32, "f64"),) for bc in range(1, 65)] + [("req", i) for i in range(40)]
    for n in (1, 2, 3, 4, 7):
        for salt in (0, 1, 17):
            got = [rendezvous_rank(s, n, salt=salt) for s in sigs]
            assert got == [ref_rendezvous_rank(s, n, salt=salt) for s in sigs]
    owners = [rendezvous_rank(s, 4) for s in sigs[:64]]
    assert set(owners) == {0, 1, 2, 3}
    assert owners != [rendezvous_rank(s, 4, salt=1) for s in sigs[:64]]


def test_rendezvous_minimal_disruption_on_replica_removal():
    sigs = [((bc, bs, m, "f64"),) for bc in range(1, 33) for bs, m in ((8, 32), (16, 64))]
    before = {s: rendezvous_rank(s, 4) for s in sigs}
    after = {s: rendezvous_rank(s, 3) for s in sigs}
    for s in sigs:
        if before[s] < 3:
            assert after[s] == before[s]


def test_rendezvous_rejects_zero_replicas():
    with pytest.raises(ValueError):
        rendezvous_rank(("x",), 0)


@pytest.mark.parametrize("kw", [
    dict(bs_pred=8, m_pred=32, chunk_size=512), dict(bs_pred=8, m_pred=48, chunk_size=64),
    dict(bs_pred=8, m_pred=32, chunk_size=64, precision="f32"),
    dict(bs_pred=8, m_pred=32, chunk_size=64, precision="bf16"),
    dict(bs_pred=8, m_pred=32, chunk_size=64, n_buckets=2),
    dict(bs_pred=25, m_pred=200, chunk_size=4096, n_buckets=4, backend="ref"),
    dict(bs_pred=25, m_pred=120, chunk_size=None)])
def test_signature_equals_reference(kw):
    for n in (1, 7, 64, 100, 104, 3000, 8192, 50_000):
        assert request_shape_signature(n, PipelineConfig(**kw)) == \
            ref_signature(n, RefPipelineConfig(**kw))


def test_signature_equal_sizes_share_equal_keys():
    cfg = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=512)
    assert request_shape_signature(100, cfg) == request_shape_signature(104, cfg)
    assert request_shape_signature(3000, cfg) != request_shape_signature(100, cfg)
    bucketed = PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64, n_buckets=2)
    assert any(k[0] == "buckets" for k in request_shape_signature(100, bucketed))


# -- construction contracts -------------------------------------------------


def test_router_refuses_drain_mode_and_mismatched_replicas(problem):
    params, _, x, y = problem
    drain = GPServerConfig(pipeline=PipelineConfig(bs_pred=8, m_pred=32, chunk_size=64),
                           scheduler=None, seed=3)
    with pytest.raises(ValueError, match="drain"):
        ReplicaRouter([GPServer(params, x, y, drain, device="cpu")])
    a = GPServer(params, x, y, _server_cfg(seed=3), device="cpu")
    for other in (_server_cfg(seed=4), _server_cfg(m_pred=48)):
        b = GPServer(params, x, y, other, index=a.index, device="cpu")
        with pytest.raises(ValueError, match="disagree"):
            ReplicaRouter([a, b])
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(ValueError):
        ReplicaRouter([a], routing="sticky")


# -- routing policy (stub replicas: no numerics) ----------------------------


class _StubReplica:
    def __init__(self, outstanding=0, reject=False):
        self.outstanding_points = outstanding
        self.reject = reject
        self.submitted = []

    def submit(self, x, slo="interactive", outputs=None):
        if self.reject:
            raise AdmissionQueueFull("full")
        self.submitted.append(np.asarray(x).shape[0])
        return "fut"


def test_affinity_prefers_rendezvous_owner():
    reps = [_StubReplica() for _ in range(3)]
    r = ReplicaRouter(reps, routing="affinity")
    pref = r.preferred_replica(100)
    for _ in range(5):
        r.submit(np.zeros((100, 3)))
    assert len(reps[pref].submitted) == 5
    s = r.stats.summary()
    assert s["affinity_hit_rate"] == 1.0 and s["n_spilled"] == 0


def test_spill_and_admission_full_chain():
    reps = [_StubReplica() for _ in range(3)]
    r = ReplicaRouter(reps, routing="affinity", spill_points=500)
    pref = r.preferred_replica(64)
    reps[pref].outstanding_points = 1000
    r.submit(np.zeros((64, 3)))
    assert [i for i, rep in enumerate(reps) if rep.submitted] != [pref]
    assert r.stats.summary()["n_spilled"] == 1
    reps[pref].outstanding_points = 100
    r.submit(np.zeros((64, 3)))
    assert len(reps[pref].submitted) == 1
    busy = [_StubReplica(outstanding=1000) for _ in range(3)]
    rb = ReplicaRouter(busy, routing="affinity", spill_points=500)
    rb.submit(np.zeros((64, 3)))
    assert len(busy[rb.preferred_replica(64)].submitted) == 1
    full = [_StubReplica(reject=True) for _ in range(3)]
    rf = ReplicaRouter(full, routing="affinity")
    with pytest.raises(AdmissionQueueFull):
        rf.submit(np.zeros((64, 3)))
    spare = (rf.preferred_replica(64) + 1) % 3
    full[spare].reject = False
    rf.submit(np.zeros((64, 3)))
    assert len(full[spare].submitted) == 1


def test_round_robin_rotates_and_random_is_seeded():
    reps = [_StubReplica() for _ in range(3)]
    r = ReplicaRouter(reps, routing="round_robin")
    for n in (10, 20, 30, 10, 20, 30):
        r.submit(np.zeros((n, 2)))
    assert [len(rep.submitted) for rep in reps] == [2, 2, 2]
    s = r.stats.summary()
    assert s["n_requests"] == 6 and s["n_points"] == 120
    picks = []
    for seed in (7, 7, 8):
        reps = [_StubReplica() for _ in range(3)]
        r = ReplicaRouter(reps, routing="random", seed=seed)
        for _ in range(16):
            r.submit(np.zeros((10, 2)))
        picks.append(tuple(len(rep.submitted) for rep in reps))
    assert picks[0] == picks[1]


# -- parity: routing never changes a result ---------------------------------


ROUTED_SIZES = (33, 70, 33, 12, 70, 1)


def _routed(problem, routing):
    """The requests of ROUTED_SIZES through 3 replicas: ``(requests, results)``."""
    reps = _make_replicas(problem, 3)
    rng = np.random.default_rng(5)
    requests = [rng.uniform(size=(n, 4)) for n in ROUTED_SIZES]
    router = ReplicaRouter(reps, routing=routing, seed=1)
    with router:
        futs = [router.submit(xq) for xq in requests]
        router.flush()
        results = [f.result(timeout=WAIT) for f in futs]
    assert router.stats.summary()["n_requests"] == len(requests)
    return requests, results


@pytest.mark.parametrize("routing", ["affinity", "random", "round_robin"])
def test_routed_requests_match_lone_predict_sbv(problem, routing):
    params, ref_params, x, y = problem
    requests, results = _routed(problem, routing)
    for i, (xq, res) in enumerate(zip(requests, results)):
        assert_parity(res.mean, res.var, port_predict(params, x, y, xq, 8, 32, 3, 64), PARITY)
        if routing == "affinity" and i < 2:
            tol = conditioning_tol(params, x, y, xq, 8, 32, 3, 64)
            assert_parity(res.mean, res.var, ref_predict(ref_params, x, y, xq, 8, 32, 3, 64),
                          tol)


@pytest.fixture(scope="module")
def conditioned():
    """The well-conditioned fixture and the reference's lone prediction of
    each routed request."""
    x, y, ref_params, params = conditioned_problem(seed=0, n=400, d=4)
    rng = np.random.default_rng(5)
    want = [ref_predict(ref_params, x, y, rng.uniform(size=(n, 4)), 8, 32, 3, 64)
            for n in ROUTED_SIZES]
    return (params, ref_params, x, y), want


@pytest.mark.parametrize("routing", ["affinity", "random", "round_robin"])
def test_well_conditioned_routed_requests_match_reference(conditioned, routing):
    """At nugget 1e-2, under every policy, each routed request equals the
    reference's lone ``predict_sbv`` within 1e-12."""
    problem, want = conditioned
    _, results = _routed(problem, routing)
    for res, w in zip(results, want):
        assert_parity(res.mean, res.var, w, PARITY)


def test_affinity_colocates_and_round_robin_sprays_shapes(problem):
    rng = np.random.default_rng(6)
    requests = [rng.uniform(size=(64, 4)) for _ in range(9)]

    def shapes_touched(routing):
        reps = _make_replicas(problem, 3)
        router = ReplicaRouter(reps, routing=routing, seed=0)
        with router:
            futs = [router.submit(xq) for xq in requests]
            router.flush()
            [f.result(timeout=WAIT) for f in futs]
        return [len(rep.stats.compiled_shape_keys()) for rep in reps]

    aff, rr = shapes_touched("affinity"), shapes_touched("round_robin")
    assert sum(1 for v in aff if v > 0) == 1
    assert sum(1 for v in rr if v > 0) == 3
    assert sum(aff) < sum(rr)


def test_concurrent_submits_are_thread_safe(problem):
    params, _, x, y = problem
    reps = _make_replicas(problem, 2)
    router = ReplicaRouter(reps, routing="affinity", seed=0)
    rng = np.random.default_rng(9)
    requests = [rng.uniform(size=(24, 4)) for _ in range(12)]
    futs = [None] * len(requests)
    with router:
        def worker(k):
            futs[k] = router.submit(requests[k])

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        router.flush()
        results = [f.result(timeout=WAIT) for f in futs]
    for xq, res in zip(requests, results):
        assert_parity(res.mean, res.var, port_predict(params, x, y, xq, 8, 32, 3, 64), PARITY)
    assert router.stats.summary()["n_requests"] == len(requests)


# -- the multi-host serve plane (real rank subprocesses) --------------------


def test_two_rank_serve_and_multihost_predict_parity(tmp_path):
    """The reference test's run on the port's CLI: 2 gloo ranks each serve
    their rendezvous-owned slice through a local router, then run
    ``predict_sbv(multihost=)`` against their serial prediction."""
    result = str(tmp_path / "serve.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "gp",
           "--n-train", "500", "--n-test", "600", "--chunk", "256", "--bs-pred", "8",
           "--m-pred", "30", "--requests", "6", "--distributed-hosts", "2", "--seed", "0",
           "--device", "cpu", "--timeout", str(RANK_TIMEOUT), "--result-json", result]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, f"distributed serve failed:\n{proc.stdout}\n{proc.stderr}"
    with open(result) as f:
        merged = json.load(f)
    assert merged["n_hosts"] == 2 and len(merged["ranks"]) == 2
    assert merged["n_requests"] == 6 and merged["n_points"] == 600
    assert merged["multihost_mean_var_max"] == 0.0
    assert merged["multihost_sim_max"] <= 1e-8
    assert merged["multihost_parity_max"] <= 1e-8
    assert merged["served_parity_max"] <= 1e-12
    assert all(rk["n_requests"] > 0 for rk in merged["ranks"])
    # Which rank owns which request is the reference's table.
    owners = [ref_rendezvous_rank(("req", i), 2, salt=0) for i in range(6)]
    assert [rk["n_requests"] for rk in merged["ranks"]] == [owners.count(0), owners.count(1)]
