"""Port vs reference: the multi-host streaming build, fit and prediction.

The reference's contract (tests/test_multihost.py): K rank processes, each
owning one row partition of a shared store, produce the SAME fit as the
single-process streaming path. Here the ranks are fresh interpreters in a
gloo process group (``repro_torch.multihost``), started by
``spawn_ranks`` (tests/_torch_mh_rank.py) or by
``python -m repro_torch.launch.fit_gp --distributed-hosts``, each with its
own timeout, so a hung rendezvous fails one test. Tolerances:
- ``partition_blocks``, and the port's ``multihost_preprocess`` under a
  ``LoopbackComm`` against the reference's under its own: bitwise (blocks,
  neighbour lists, plan, packed pieces);
- ``LoopbackComm`` fit and prediction against the port's serial path:
  bitwise;
- real ranks (2 and 3) with one structure window per partition: the
  structure bitwise equal to the serial ``streaming_preprocess`` (with
  more windows per partition the centroid sums associate differently);
- the 2-rank fit at the reference's fixture (n = 2000, d = 4, 24 blocks,
  m = 8, 4 x 2 steps, chunk 600): spread 0.0 across ranks and within 1e-8
  of the reference's serial streaming fit, peak RSS within 2x the
  per-host working-set model;
- the 2-rank prediction: mean and variance bitwise serial, the simulation
  columns within 1e-8.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.pipeline import SBVConfig as RefConfig  # noqa: E402
from repro.data import store as ref_store  # noqa: E402
from repro.data import streaming as ref_st  # noqa: E402
from repro.data.gp_sim import paper_synthetic  # noqa: E402
from repro.multihost import LoopbackComm as RefLoopback  # noqa: E402
from repro.multihost import partition_blocks as ref_partition_blocks  # noqa: E402
from repro_torch.core import SBVConfig  # noqa: E402
from repro_torch.core.fit import fit_sbv  # noqa: E402
from repro_torch.core.kernels_math import KernelParams  # noqa: E402
from repro_torch.core.predict import predict_sbv  # noqa: E402
from repro_torch.data import streaming as st  # noqa: E402
from repro_torch.data.store import ArrayStore, MemoryStore, PartitionedStore  # noqa: E402
from repro_torch.multihost import (LoopbackComm, MultihostContext, partition_blocks,  # noqa: E402
                                   spawn_ranks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_mh_rank.py")
# The reference's fixture for every serial-vs-distributed fit comparison.
BLOCKS, M, INNER, OUTER, CHUNK, SEED = 24, 8, 4, 2, 600, 0
RANK_TIMEOUT = 120.0   # each rank, its rendezvous and its collectives
RUN_TIMEOUT = 240      # a launcher subprocess as a whole
PIECE_KEYS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_rank():
    """Rank processes inherit one intra-op thread: the suite runs beside
    other workers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _spawn(k, *args):
    results = spawn_ranks([sys.executable, HELPER, *map(str, args)], k,
                          timeout_s=RANK_TIMEOUT)
    for r, (code, text) in enumerate(results):
        assert code == 0, f"rank {r} exited with {code}:\n{text}"
    return results


def _ranks(out, k):
    return [dict(np.load(f"{out}.rank{r}.npz")) for r in range(k)]


def _split(cat, lens):
    return np.split(cat, np.cumsum(lens)[:-1]) if len(lens) else []


# -- in-process layers --------------------------------------------------------


def test_partition_blocks_spans_match_reference():
    assert partition_blocks(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert partition_blocks(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    for n, k in ((1, 1), (17, 5), (64, 8), (0, 3), (1000, 7)):
        spans = partition_blocks(n, k)
        assert spans == ref_partition_blocks(n, k)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.fixture(scope="module")
def lb_store():
    x, y, _ = paper_synthetic(seed=0, n=900, d=3)
    return x, y


def test_loopback_fit_is_bitwise_serial(lb_store):
    """``multihost=LoopbackComm()`` is the identity on the fit: the
    multi-host path with one rank reproduces the port's streaming fit
    bitwise (allreduce is a copy, exchange a loopback)."""
    x, y = lb_store
    cfg = SBVConfig(n_blocks=16, m=M, seed=SEED)
    kw = dict(inner_steps=3, outer_rounds=2, stream_chunk=400, device_cache=0, device="cpu")
    ref = fit_sbv(MemoryStore(x, y), None, cfg, **kw)
    mh = fit_sbv(MemoryStore(x, y), None, cfg, multihost=LoopbackComm(), **kw)
    assert [h[:2] for h in ref.history] == [h[:2] for h in mh.history]
    assert all(a[2] == b[2] for a, b in zip(ref.history, mh.history))
    for a, b in zip(ref.params, mh.params):
        assert torch.equal(a, b)
    s = mh.stream_stats
    assert s["n_hosts"] == 1 and s["lockstep_chunks"] == s["n_pieces"]
    assert s["allreduce_scalars_per_chunk"] == 1 + 3 + 2


@pytest.mark.parametrize("n_buckets", [None, 2])
def test_loopback_predict_is_bitwise_serial(lb_store, n_buckets):
    """``predict_sbv(multihost=LoopbackComm())`` owns every block span, so
    it reproduces the plain predict bitwise."""
    x, y = lb_store
    params = KernelParams.create(sigma2=1.0, beta=0.3, nugget=1e-3, d=3)
    xq = np.random.default_rng(1).uniform(size=(111, 3))
    kw = dict(bs_pred=8, m_pred=24, seed=3, n_sims=3, chunk_size=64, device="cpu",
              n_buckets=n_buckets)
    ref = predict_sbv(params, x, y, xq, **kw)
    mh = predict_sbv(params, x, y, xq, multihost=LoopbackComm(), **kw)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        assert np.array_equal(getattr(ref, f), getattr(mh, f)), f


def test_loopback_structure_matches_reference(tmp_path):
    """The port's ``multihost_preprocess`` over a one-part
    ``PartitionedStore`` and a ``LoopbackComm`` against the reference's,
    on a store the reference wrote: bitwise blocks, neighbour lists, plan,
    packed pieces, sizes and owners; and the same as the port's serial
    ``streaming_preprocess``."""
    x, y, _ = paper_synthetic(seed=2, n=1500, d=4)
    path = str(tmp_path / "s")
    ref_store.ArrayStore.from_arrays(path, x, y, shard_rows=412)
    beta = np.full(4, 0.4)
    ours = st.multihost_preprocess(PartitionedStore(ArrayStore(path), 1, 0), beta,
                                   SBVConfig(n_blocks=BLOCKS, m=20, seed=SEED), 300,
                                   LoopbackComm())
    theirs = ref_st.multihost_preprocess(ref_store.PartitionedStore(ref_store.ArrayStore(path),
                                                                    1, 0), beta,
                                         RefConfig(n_blocks=BLOCKS, m=20, seed=SEED), 300,
                                         RefLoopback())
    serial = st.streaming_preprocess(ArrayStore(path), beta,
                                     SBVConfig(n_blocks=BLOCKS, m=20, seed=SEED), 300)
    for other in (theirs, serial):
        for f in ("order", "rank_of_block", "centers", "owners"):
            np.testing.assert_array_equal(getattr(ours.blocks, f), getattr(other.blocks, f))
        for a, b in zip(ours.blocks.members, other.blocks.members):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.neigh, other.neigh):
            np.testing.assert_array_equal(a, b)
        assert len(ours.plan) == len(other.plan)
        for a, b in zip(ours.plan, other.plan):
            np.testing.assert_array_equal(a, b)
        assert ours.bs_max == other.bs_max and ours.domain_volume == other.domain_volume
    np.testing.assert_array_equal(ours.sizes, theirs.sizes)
    np.testing.assert_array_equal(ours.host_of_block, theirs.host_of_block)
    for r in ours.plan:
        got = st.pack_block_chunk(ours.table, ours.blocks, ours.neigh, r, m=20,
                                  bs_max=ours.bs_max)
        want = ref_st.pack_block_chunk(theirs.table, theirs.blocks, theirs.neigh, r, m=20,
                                       bs_max=theirs.bs_max)
        for k in PIECE_KEYS + ("owners",):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    keys = ("rows_local", "owned_rows", "owned_blocks", "halo_rounds", "halo_blocks",
            "halo_rows")
    assert {k: ours.stats[k] for k in keys} == {k: theirs.stats[k] for k in keys}
    mean, var = st.streaming_moments(ArrayStore(path), comm=LoopbackComm())
    assert (mean, var) == ref_st.streaming_moments(ref_store.ArrayStore(path),
                                                   comm=RefLoopback())


def test_per_host_working_set_terms_match_reference():
    """The multi-host terms of ``working_set_model`` are the reference's."""
    stats = dict(bs_max=40, bc=24, packed_chunk_bytes_max=1 << 20, spool_bytes=4 << 20,
                 backward_blocks=16, backward_itemsize=8, n_hosts=2, owned_rows=1100,
                 halo_rows=700, rows_local=1024, device_cached_bytes=0)
    ours = st.working_set_model(stats, 2000, 4, 8, 600)
    theirs = ref_st.working_set_model(stats, 2000, 4, 8, 600)
    for k in ("chunk_windows", "packed_chunk", "nns_scan", "index_arrays", "gather_caches",
              "row_table", "partition_pass"):
        assert ours["terms"][k] == theirs["terms"][k], k
    assert set(ours["terms"]) == set(theirs["terms"])


def test_failed_rendezvous_raises():
    """No store at the coordinator: ``connect`` raises within its timeout
    (it never turns into a LoopbackComm)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception) as err:
        MultihostContext.connect(f"127.0.0.1:{port}", 2, 1, timeout_s=2.0, host_store=False)
    assert not isinstance(err.value, AssertionError)


# -- real gloo ranks ----------------------------------------------------------


def test_comm_collectives_and_exchange(tmp_path):
    """Three ranks: every rank gets the identical reduced bytes (sum in
    rank order, max, min), and ``exchange`` delivers each non-empty
    payload to its destination and nothing else."""
    out = str(tmp_path / "comm")
    _spawn(3, "comm", out)
    got = _ranks(out, 3)
    vecs = [np.asarray([r + 0.1, -r * 1e-300, 1.0 / (r + 3)]) for r in range(3)]
    want_sum = (vecs[0] + vecs[1]) + vecs[2]
    for r, g in enumerate(got):
        assert g["sum"].tobytes() == want_sum.tobytes()
        assert g["max"].tobytes() == np.max(vecs, axis=0).tobytes()
        assert g["min"].tobytes() == np.min(vecs, axis=0).tobytes()
        assert float(g["scalar"]) == 2.0
        # rank s addresses everyone except (s + 1) % 3, itself included
        srcs = [s for s in range(3) if (s + 1) % 3 != r]
        assert g["srcs"].tolist() == srcs and g["echo"].tolist() == srcs
        assert g["rows"].tolist() == [r + 1] * len(srcs)
    assert sum(int(g["bytes_sent"]) for g in got) == sum(int(g["bytes_recv"]) for g in got) > 0


def test_failed_rank_fails_the_launch_quickly(tmp_path):
    """A rank that dies takes its peer down with it: ``spawn_ranks`` kills
    the rank left waiting in a collective instead of waiting out its
    timeout."""
    import time

    t0 = time.monotonic()
    results = spawn_ranks([sys.executable, HELPER, "fail", str(tmp_path / "x")], 2,
                          timeout_s=RANK_TIMEOUT)
    assert results[1][0] == 3 and results[0][0] != 0
    assert time.monotonic() - t0 < RANK_TIMEOUT / 2


@pytest.mark.parametrize("k,n", [(2, 2000), (3, 2001)])
def test_real_rank_structure_is_bitwise_serial(tmp_path, k, n):
    """K gloo ranks over a store whose partitions are one structure window
    each: the replicated summaries (order, centers, owners, sizes), each
    rank's owned members and neighbour lists and its packed pieces are
    bitwise the serial ``streaming_preprocess``'s; every block is owned
    exactly once."""
    x, y, _ = paper_synthetic(seed=3, n=n, d=4)
    part = -(-n // k)
    path = str(tmp_path / "s")
    store = ArrayStore.from_arrays(path, x, y, shard_rows=part)
    out = str(tmp_path / "structure")
    _spawn(k, "structure", path, out, BLOCKS, M, CHUNK, part)
    got = _ranks(out, k)
    cfg = SBVConfig(n_blocks=BLOCKS, m=M, seed=0, n_workers=k)
    serial = st.streaming_preprocess(store, np.full(4, 0.4), cfg, CHUNK, struct_batch=part)
    owned_all = np.concatenate([g["owned"] for g in got])
    assert sorted(owned_all.tolist()) == list(range(serial.blocks.n_blocks))
    for g in got:
        for f in ("order", "rank_of_block", "centers"):
            np.testing.assert_array_equal(g[f], getattr(serial.blocks, f))
        np.testing.assert_array_equal(g["host_of_block"], serial.blocks.owners)
        np.testing.assert_array_equal(g["sizes"],
                                      [mb.size for mb in serial.blocks.members])
        assert float(g["domain_volume"]) == serial.domain_volume
        assert int(g["bs_max"]) == serial.bs_max
        for b, mb, nb in zip(g["owned"], _split(g["members"], g["members_len"]),
                             _split(g["neigh"], g["neigh_len"])):
            np.testing.assert_array_equal(mb, serial.blocks.members[b])
            np.testing.assert_array_equal(nb, serial.neigh[b])
        plan = _split(g["plan"], g["plan_len"])
        assert int(g["owned_rows"]) == sum(serial.blocks.members[b].size for b in g["owned"])
        if not plan:
            continue
        pieces = [st.pack_block_chunk(store, serial.blocks, serial.neigh, r, m=M,
                                      bs_max=serial.bs_max) for r in plan]
        for key in PIECE_KEYS:
            np.testing.assert_array_equal(g[key],
                                          np.concatenate([getattr(p, key) for p in pieces]))


@pytest.fixture(scope="module")
def mh_store(tmp_path_factory):
    x, y, _ = paper_synthetic(seed=0, n=2000, d=4)
    path = str(tmp_path_factory.mktemp("mh") / "store")
    return ArrayStore.from_arrays(path, x, y, shard_rows=512)


def test_two_rank_fit_gp_matches_reference_serial(mh_store, tmp_path):
    """``fit_gp --distributed-hosts 2 --device cpu``: every rank lands on
    the same nll (spread 0.0), within 1e-8 of the reference's serial
    streaming fit; each rank's peak RSS within 2x its working-set model."""
    result = str(tmp_path / "result.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.fit_gp", "--store", mh_store.path,
           "--distributed-hosts", "2", "--blocks", BLOCKS, "--m", M,
           "--inner-steps", INNER, "--outer-rounds", OUTER, "--stream-chunk", CHUNK,
           "--device-cache-mb", "0", "--seed", SEED, "--device", "cpu",
           "--timeout", RANK_TIMEOUT, "--result-json", result]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([str(c) for c in cmd], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT)
    assert proc.returncode == 0, f"distributed fit failed:\n{proc.stdout}\n{proc.stderr}"
    assert "[fit_gp] merged 2 rank results" in proc.stdout
    with open(result) as f:
        merged = json.load(f)
    serial = ref_fit(ref_store.ArrayStore(mh_store.path), None,
                     RefConfig(n_blocks=BLOCKS, m=M, seed=SEED), inner_steps=INNER,
                     outer_rounds=OUTER, backend="ref", stream_chunk=CHUNK, device_cache=0)
    assert merged["n_hosts"] == 2 and len(merged["ranks"]) == 2
    assert merged["max_nll_spread"] == 0.0
    assert abs(merged["nll"] - float(serial.history[-1][2])) <= 1e-8
    for rk in merged["ranks"]:
        s = rk["stats"]
        assert s["n_hosts"] == 2 and s["lockstep_chunks"] >= s["n_pieces"] >= 1
        assert s["owned_rows"] + s["halo_rows"] <= 2000 and s["exchange_bytes"] > 0
        assert rk["peak_rss_bytes"] is None or \
            rk["peak_rss_bytes"] <= 2 * rk["working_set_bytes"], rk
        assert set(rk["launches"]) >= {"sbv_loglik", "sbv_predict"}


def test_two_rank_predict_is_bitwise_serial(mh_store, tmp_path):
    """``predict_sbv(multihost=)`` on 2 gloo ranks, uniform and bucketed:
    mean and variance bitwise the serial call's, simulation columns
    within 1e-8."""
    sys.path.insert(0, os.path.dirname(HELPER))
    try:
        from _torch_mh_rank import PREDICT_KW
    finally:
        sys.path.pop(0)
    xq = np.random.default_rng(5).uniform(size=(150, 4))
    xt = str(tmp_path / "xq.npy")
    np.save(xt, xq)
    out = str(tmp_path / "pred")
    _spawn(2, "predict", mh_store.path, xt, out)
    got = _ranks(out, 2)
    x, y = mh_store.read_slice(0, mh_store.n_rows)
    params = KernelParams.create(sigma2=1.0, beta=0.3, nugget=1e-3, d=4)
    for tag, nb in (("uniform", None), ("bucketed", 2)):
        want = predict_sbv(params, x, y, xq, n_buckets=nb, **PREDICT_KW)
        for g in got:
            for f in ("mean", "var"):
                assert np.array_equal(g[f"{tag}_{f}"], getattr(want, f)), (tag, f)
            for f in ("sim_mean", "ci_low", "ci_high"):
                np.testing.assert_allclose(g[f"{tag}_{f}"], getattr(want, f), rtol=0,
                                           atol=1e-8)
