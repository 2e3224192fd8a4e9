"""Port vs reference: the in-process distributed SBV likelihood, fit and
prediction (paper Alg. 1 steps 4-5) over a worker mesh on the CPU.

The reference's fixture (tests/test_distributed_gp.py): ``paper_synthetic
(seed=0, n=400, d=4)``, ``SBVConfig(n_blocks=48, m=20, n_workers=k)``. The
reference's own 8-virtual-device XLA subprocess is not started here; its
serial functions are the expected values. Tolerances:
- ``shard_blocks_by_owner`` / ``shard_prediction_by_owner``: bitwise;
- 1-, 3- and 8-worker meshes (workers sharing the CPU), uniform and
  bucketed, at the fit's initial parameters (nugget 1e-3) and at the
  generator's (nugget 1e-8, cond(K) ~1e9: ROADMAP fault 2): the loss
  against the port's serial loss at rtol 1e-12 and every gradient leaf
  within the limit of a reordered f64 sum (``_reorder_limit``; only the
  summation order differs), and both against the reference's serial
  ``packed_loglik`` / ``bucketed_loglik`` and ``jax.grad`` at rtol 1e-10
  (1e-9 at the generator's parameters). The reference holds its own
  distributed result to its serial one at 1e-10; the port's SERIAL plain
  version is already up to 1.4e-11 (loss, initial parameters) and 1e-10
  (gradient, generator's) from the reference's, so 1e-12 against the
  reference is out of reach of the serial path itself;
- the distributed fit history, in core, bucketed and streaming, against
  the port's serial fit at rtol 1e-10;
- ``sharded_packed_predict`` against the serial conditional: bitwise after
  the scatter (one block's conditional does not depend on its shard).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SBVConfig as RefConfig  # noqa: E402
from repro.core import buckets as ref_buckets  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core import vecchia as ref_vecchia  # noqa: E402
from repro.core.predict import build_train_index as ref_index  # noqa: E402
from repro.core.predict import pack_queries as ref_pack_queries  # noqa: E402
from repro.data.gp_sim import paper_synthetic  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import SBVConfig, buckets, preprocess  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core.fit import _value_and_grad, fit_sbv, neg_loglik_fn  # noqa: E402
from repro_torch.data.store import MemoryStore  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh  # noqa: E402

FIELDS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask", "owners")
PRED_FIELDS = ("q_x", "q_mask", "q_idx", "nn_x", "nn_y", "nn_mask", "owners")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return paper_synthetic(seed=0, n=400, d=4)


def _packed(data, k):
    x, y, params = data
    beta = np.asarray(params.beta)
    ref, _ = ref_preprocess(x, y, beta, RefConfig(n_blocks=48, m=20, n_workers=k, seed=0))
    got, _ = preprocess(x, y, beta, SBVConfig(n_blocks=48, m=20, n_workers=k, seed=0))
    return ref, got


def _cpu_mesh(k):
    return make_worker_mesh(k, devices="cpu")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_shard_by_owner_bitwise_reference(data, k):
    ref, got = _packed(data, k)
    want = ref_dist.shard_blocks_by_owner(ref, k)
    have = dist.shard_blocks_by_owner(got, k)
    assert have.n_blocks % k == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(have, f), getattr(want, f))
    x, y, params = data
    xt = np.random.default_rng(9).uniform(size=(120, 4))
    beta = np.asarray(params.beta)
    pq_ref = ref_pack_queries(ref_index(x, y, beta, 40, n_workers=4, seed=0), xt, bs_pred=8,
                              m_pred=40, seed=0, n_workers=4)
    pq = tpredict.pack_queries(tpredict.build_train_index(x, y, beta, 40, n_workers=4, seed=0),
                               xt, bs_pred=8, m_pred=40, seed=0, n_workers=4)
    want = ref_dist.shard_prediction_by_owner(pq_ref, k)
    have = dist.shard_prediction_by_owner(pq, k)
    for f in PRED_FIELDS:
        np.testing.assert_array_equal(getattr(have, f), getattr(want, f))


def _ref_value_and_grad(loss, params):
    v, g = jax.value_and_grad(loss)(params)
    return float(v), [np.asarray(a) for a in g]


def _params(data, which):
    x, y, true = data
    if which == "true":
        return true
    from repro.core import KernelParams as RefParams

    return RefParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=x.shape[1])


@pytest.mark.parametrize("which,rtol", [("init", 1e-10), ("true", 1e-9)])
@pytest.mark.parametrize("layout", ["uniform", "bucketed"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_distributed_loss_and_gradient_match_reference_serial(data, k, layout, which, rtol):
    """The port's k-worker loss closure on the CPU (the plain version per
    shard through ``ops.sbv_loglik``) against the reference's serial
    likelihood and ``jax.grad`` of it."""
    params = _params(data, which)
    ref, got = _packed(data, k)
    if layout == "bucketed":
        ref = ref_buckets.bucket_blocks(ref, n_buckets=3)
        got = buckets.bucket_blocks(got, n_buckets=3)
        ref_ll = lambda p: -ref_vecchia.bucketed_loglik(p, ref) / ref.n_points
    else:
        ref_ll = lambda p: -ref_vecchia.packed_loglik(p, ref) / ref.n_points
    want_v, want_g = _ref_value_and_grad(ref_ll, params)
    loss = dist.distributed_neg_loglik_fn(got, 3.5, _cpu_mesh(k), "workers")
    v, g = _value_and_grad(loss, params_from_reference(*(np.asarray(a) for a in params)))
    np.testing.assert_allclose(float(v), want_v, rtol=rtol)
    for a, b in zip(g, want_g):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=1e-300)
    # Against the port's serial loss: the summation order only.
    p = params_from_reference(*(np.asarray(a) for a in params))
    serial = (buckets_loss(got) if layout == "bucketed"
              else neg_loglik_fn(got, 3.5, "auto", device="cpu"))
    v1, g1 = _value_and_grad(serial, p)
    np.testing.assert_allclose(float(v), float(v1), rtol=1e-12)
    limit, block = _reorder_limit(got, k, p)
    for a, b, lim in zip(g, g1, limit):
        assert bool(((a - b).abs() <= lim).all()), (a, b, lim)
    # A planted fault lies beyond the limit: one shard's first block
    # counted twice.
    assert any(bool(((a + e - b).abs() > lim).any())
               for a, e, b, lim in zip(g, block, g1, limit))
    # The one-shot forms give the same value.
    mesh = _cpu_mesh(k)
    if layout == "bucketed":
        one = dist.distributed_bucketed_loglik(p, got, mesh)
    else:
        one = dist.distributed_loglik(p, dist.shard_blocks_by_owner(got, k), mesh)
    np.testing.assert_allclose(-float(one) / got.n_points, float(v), rtol=1e-12)


def _reorder_limit(packed, k, p):
    """Per gradient leaf, how far the k-worker gradient may lie from the
    serial one when only the summation order differs, and the gradient of
    one shard's first block (the planted fault).

    Both sum the same per-entry terms of every block's covariance
    derivative, per shard and then over the shards, or over all blocks at
    once. Either order of a recursive f64 sum of N terms lies within (N - 1)
    eps sum |terms| of the exact sum, so the two lie within 2 (N - 1) eps
    sum |terms| of each other. N is the covariance entries of all blocks,
    sum over blocks of (bs + m)^2. sum |terms| is taken as each shard's
    log-determinant part plus its quadratic part, added over the shards:
    the gradient's two sums, which cancel to a small remainder at the
    generator's parameters (the log-determinant part is the gradient at
    y = 0, the quadratic part the rest). That is at most sum |terms|, so
    the limit is the stricter."""
    from repro_torch.core.distributed import (_LOGLIK_KEYS, _shard_loglik, place_shards,
                                              shard_blocks_by_owner)

    eps = float(np.finfo(np.float64).eps)
    layouts = packed.buckets if isinstance(packed, buckets.BucketedBlocks) else [packed]
    n_terms, mags, block = 0, None, None
    for pk in layouts:
        n_terms += pk.blk_x.shape[0] * (pk.blk_x.shape[1] + pk.nn_x.shape[1]) ** 2
        pk = shard_blocks_by_owner(pk, k)
        for arrs in place_shards([getattr(pk, f) for f in _LOGLIK_KEYS], ["cpu"] * k):
            grad = lambda a: _value_and_grad(
                lambda q: -_shard_loglik(q, a, 3.5, "auto") / packed.n_points, p)[1]
            zero_y = (arrs[0], torch.zeros_like(arrs[1]), arrs[2], arrs[3],
                      torch.zeros_like(arrs[4]), arrs[5])
            whole, logdet = grad(arrs), grad(zero_y)
            m = [(w - ld).abs() + ld.abs() for w, ld in zip(whole, logdet)]
            mags = m if mags is None else [x + y for x, y in zip(mags, m)]
            if block is None:
                block = grad(tuple(t[:1] for t in arrs))
    return [2 * (n_terms - 1) * eps * m for m in mags], block


def buckets_loss(bucketed):
    """The port's serial bucketed loss, ``-bucketed_loglik / n``."""
    from repro_torch.core.vecchia import bucketed_loglik

    return lambda p: -bucketed_loglik(p, bucketed) / bucketed.n_points


@pytest.mark.parametrize("case", ["incore", "bucketed", "streaming"])
def test_distributed_fit_history_matches_serial(data, case):
    x, y, _ = data
    cfg = SBVConfig(n_blocks=48, m=20, n_workers=4, seed=0)
    kw = dict(inner_steps=4, outer_rounds=2, lr=0.1, device="cpu")
    if case == "bucketed":
        kw["n_buckets"] = 3
    if case == "streaming":
        kw.update(stream_chunk=150, device_cache=0)
    serial = fit_sbv(x, y, cfg, **kw)
    got = fit_sbv(x, y, cfg, distributed=(_cpu_mesh(4), "workers"), **kw)
    assert [h[:2] for h in got.history] == [h[:2] for h in serial.history]
    np.testing.assert_allclose([h[2] for h in got.history], [h[2] for h in serial.history],
                               rtol=1e-10)
    assert got.history[-1][2] < got.history[0][2]
    for a, b in zip(got.params, serial.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8)
    if case == "streaming":
        s = got.stream_stats
        assert s["n_shards"] == 4 and s["n_pieces"] == serial.stream_stats["n_pieces"] > 1


def test_streaming_pieces_are_padded_to_the_shard_count(data, monkeypatch):
    """Every spooled piece's block count divides the worker count and its
    blocks are owner-contiguous."""
    from repro_torch.core import fit as fit_mod

    seen = []
    real = fit_mod._chunk_grad

    def spy(params, arrays, nu, backend, n_points, shard_devices=None):
        seen.append((arrays[0].shape[0], len(shard_devices)))
        return real(params, arrays, nu, backend, n_points, shard_devices)

    monkeypatch.setattr(fit_mod, "_chunk_grad", spy)
    x, y, _ = data
    fit_sbv(MemoryStore(x, y), None, SBVConfig(n_blocks=48, m=20, n_workers=3, seed=0),
            inner_steps=1, outer_rounds=1, stream_chunk=150, device="cpu",
            distributed=(_cpu_mesh(3), "workers"))
    assert seen and all(bc % k == 0 and k == 3 for bc, k in seen)


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_packed_predict_matches_serial(data, k):
    x, y, params = data
    beta = np.asarray(params.beta)
    xt = np.random.default_rng(9).uniform(size=(120, 4))
    packed = tpredict.pack_queries(tpredict.build_train_index(x, y, beta, 40, n_workers=4,
                                                              seed=0),
                                   xt, bs_pred=8, m_pred=40, seed=0, n_workers=4)
    p = params_from_reference(*(np.asarray(a) for a in params))

    def scattered(pk, mu, var):
        m, v = np.zeros(120), np.zeros(120)
        tpredict.scatter_packed(pk, (mu, m), (var, v))
        return m, v

    m_ser, v_ser = scattered(packed, *tpredict.batched_block_predict(
        p, *(torch.as_tensor(a) for a in packed.arrays())))
    sharded, mu, var = dist.sharded_packed_predict(p, packed, _cpu_mesh(k))
    assert sharded.n_blocks % k == 0 and mu.shape == sharded.q_mask.shape
    m_d, v_d = scattered(sharded, mu, var)
    np.testing.assert_array_equal(m_d, m_ser)
    np.testing.assert_array_equal(v_d, v_ser)


def test_worker_mesh():
    mesh = make_worker_mesh(3, devices="cpu")
    assert isinstance(mesh, WorkerMesh) and mesh.size == 3 and mesh.shape == {"workers": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_worker_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="axis"):
        dist.mesh_devices(mesh, "hosts")
    with pytest.raises(ValueError):
        make_worker_mesh(0, devices="cpu")


def test_worker_mesh_needs_a_device_without_cuda(data, monkeypatch):
    """No CUDA and no ``devices``: the mesh, and a distributed fit without
    ``device``, raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_worker_mesh(2)
    x, y, _ = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_sbv(x, y, SBVConfig(n_blocks=48, m=20), inner_steps=1, outer_rounds=1,
                distributed=(make_worker_mesh(2), "workers"))


def test_refusals_match_the_reference(data):
    """What the reference refuses, with its messages."""
    x, y, _ = data
    cfg = SBVConfig(n_blocks=48, m=20)
    mesh = (_cpu_mesh(2), "workers")
    with pytest.raises(ValueError, match="mutually exclusive"):
        fit_sbv(x, y, cfg, stream_chunk=150, distributed=mesh, multihost=object(),
                device="cpu")
    with pytest.raises(ValueError, match="requires the streaming path"):
        fit_sbv(x, y, cfg, multihost=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="multihost=/distributed="):
        fit_sbv(x, np.stack([y, y], axis=1), cfg, distributed=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="multihost mode"):
        fit_sbv(x, y, cfg, stream_chunk=150, multihost=object(), n_buckets=2, device="cpu")


def test_fit_gp_cli_in_core_with_workers(capsys, tmp_path):
    """``fit_gp --workers 3 --device cpu`` fits in core over a 3-worker mesh
    and prints the reference CLI's lines; ``--tuning-record`` on a directory
    that holds no record refuses to start."""
    from repro_torch.launch import fit_gp

    out = str(tmp_path / "r.json")
    fit_gp.main(["--n", "600", "--blocks", "12", "--m", "10", "--m-pred", "20",
                 "--inner-steps", "2", "--outer-rounds", "1", "--workers", "3",
                 "--device", "cpu", "--result-json", out])
    text = capsys.readouterr().out
    assert "[fit_gp] fit 540 pts" in text and "[fit_gp] predict 60 pts" in text
    import json

    with open(out) as f:
        assert np.isfinite(json.load(f)["nll"])
    with pytest.raises(FileNotFoundError, match="no tuning record"):
        fit_gp.main(["--n", "600", "--blocks", "12", "--m", "10", "--tuning-record",
                     str(tmp_path), "--device", "cpu"])
