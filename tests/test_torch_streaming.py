"""Port vs reference: the out-of-core streaming fit and prediction on the CPU.

The reference's fixture (tests/test_streaming.py): ``paper_synthetic(seed=0,
n=1500, d=4)``, ``SBVConfig(n_blocks=24, m=20)``, ``stream_chunk`` 300 / 400.
Tolerances:
- structure, neighbour lists, plans and packed pieces: bitwise;
- the streaming fit against the reference's (``backend='ref'`` on both):
  first loss rtol 1e-10, history and params rtol 1e-6 (the Adam update is
  taken in float32, as tests/test_torch_slice.py holds the in-core fit);
- within the port: store == in-core and every spool tier and prefetch
  depth bitwise; chunked vs one piece and bucketed vs uniform 1e-10;
- multi-output streaming fit rtol 1e-8 (tests/test_torch_multioutput.py);
- streaming predict mean / var 1e-10 at nugget 1e-3 (ROADMAP fault 2; the
  reference's draws injected);
  the exact-GP oracle at m_pred >= n atol 1e-4 (the reference's own).
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import KernelParams as RefParams  # noqa: E402
from repro.core import multioutput as ref_mo  # noqa: E402
from repro.core.exact_gp import exact_predict as ref_exact_predict  # noqa: E402
from repro.core.fit import fit_neldermead as ref_neldermead  # noqa: E402
from repro.core.fit import fit_sbv as ref_fit  # noqa: E402
from repro.core.pipeline import SBVConfig as RefConfig  # noqa: E402
from repro.core.predict import build_train_index as ref_index  # noqa: E402
from repro.core.predict import predict_sbv as ref_predict  # noqa: E402
from repro.data import store as ref_store  # noqa: E402
from repro.data import streaming as ref_st  # noqa: E402
from repro.data.gp_sim import paper_synthetic  # noqa: E402
from repro_torch.convert import (multi_params_to_reference, params_from_reference,  # noqa: E402
                                 params_to_reference)
from repro_torch.core import SBVConfig  # noqa: E402
from repro_torch.core import predict as tpredict  # noqa: E402
from repro_torch.core.fit import fit_neldermead, fit_sbv  # noqa: E402
from repro_torch.data import streaming as st  # noqa: E402
from repro_torch.data.store import ArrayStore, MemoryStore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CFG = dict(n_blocks=24, m=20, seed=0)
PACKED = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask", "owners")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small CPU ops: one intra-op thread runs them faster
    than a pool spinning against the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    x, y, params = paper_synthetic(seed=0, n=1500, d=4)
    return x, y, params


@pytest.fixture(scope="module")
def ref_store_dir(tmp_path_factory, small):
    """A store written by the reference, read by both packages."""
    x, y, _ = small
    path = str(tmp_path_factory.mktemp("refstore") / "s")
    ref_store.ArrayStore.from_arrays(path, x, y, shard_rows=412)
    return path


def _leaves(p):
    return [np.asarray(a) for a in p]


def _history(r):
    return [h[2] for h in r.history]


def _assert_fits_equal(a, b):
    assert _history(a) == _history(b)
    for u, v in zip(a.params, b.params):
        assert torch.equal(u, v)


# -- host structure: bitwise -------------------------------------------------


def test_streaming_moments_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(4000, 3))
    y = 1e8 + rng.standard_normal(4000)
    got = st.streaming_moments(MemoryStore(x, y), batch_rows=700)
    assert got == ref_st.streaming_moments(MemoryStore(x, y), batch_rows=700)
    assert np.isclose(got[1], y.var(), rtol=1e-9)
    disk = ArrayStore.from_arrays(str(tmp_path / "mo"), x, y, shard_rows=512)
    assert st.streaming_moments(disk, batch_rows=700) == got


@pytest.mark.parametrize("ordering", ["random", "coord", "maxmin"])
def test_streaming_kmeans_matches_reference_bitwise(small, ref_store_dir, ordering):
    x, y, _ = small
    beta = np.asarray([0.05, 0.05, 5.0, 5.0])
    want = ref_st.streaming_kmeans_blocks(MemoryStore(x, y), beta, 30, seed=1,
                                          batch_rows=256, ordering=ordering, n_workers=2)
    for store in (MemoryStore(x, y), ArrayStore(ref_store_dir)):
        got = st.streaming_kmeans_blocks(store, beta, 30, seed=1, batch_rows=256,
                                         ordering=ordering, n_workers=2)
        for f in ("labels", "order", "rank_of_block", "centers", "owners"):
            np.testing.assert_array_equal(getattr(got[0], f), getattr(want[0], f), err_msg=f)
        assert all(np.array_equal(a, b) for a, b in zip(got[0].members, want[0].members))
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_streaming_structure_plan_and_pieces_match_reference_bitwise(small, ref_store_dir):
    """``streaming_preprocess`` (k-means, store-backed NNS, plan) and every
    packed piece, from the reference-written store, against the reference."""
    beta = np.full(4, 0.5)
    store, rstore = ArrayStore(ref_store_dir), ref_store.ArrayStore(ref_store_dir)
    got = st.streaming_preprocess(store, beta, SBVConfig(**CFG), 300)
    want = ref_st.streaming_preprocess(rstore, beta, RefConfig(**CFG), 300)
    assert got.bs_max == want.bs_max and got.domain_volume == want.domain_volume
    assert len(got.neigh) == len(want.neigh)
    assert all(np.array_equal(a, b) for a, b in zip(got.neigh, want.neigh))
    assert len(got.plan) == len(want.plan) > 3
    assert all(np.array_equal(a, b) for a, b in zip(got.plan, want.plan))
    assert got.flat.gathered_rows == want.flat.gathered_rows
    for ranks in got.plan:
        pg = st.pack_block_chunk(store, got.blocks, got.neigh, ranks, m=20, bs_max=got.bs_max)
        pw = ref_st.pack_block_chunk(rstore, want.blocks, want.neigh, ranks, m=20,
                                     bs_max=want.bs_max)
        for f in PACKED:
            np.testing.assert_array_equal(getattr(pg, f), getattr(pw, f), err_msg=f)
    # A restricted rank sequence plans like the reference too.
    ranks = np.arange(0, len(got.blocks.order), 2)
    assert all(np.array_equal(a, b) for a, b in zip(
        st.plan_block_chunks(got.blocks, got.neigh, 20, 150, ranks=ranks),
        ref_st.plan_block_chunks(want.blocks, want.neigh, 20, 150, ranks=ranks)))


def test_lazy_flat_blocks_duplicate_ids_accounted_once(small, ref_store_dir):
    store = ArrayStore(ref_store_dir)
    beta = np.full(4, 0.5)
    blocks, radii, _ = st.streaming_kmeans_blocks(store, beta, 12, seed=0)
    flat = st.LazyFlatBlocks(blocks, radii, store, beta)
    out = flat.points_of_blocks(np.array([3, 3, 5, 3]))
    assert out.shape == (3 * flat.sizes[3] + flat.sizes[5], 4)
    assert flat.gathered_rows == flat.sizes[3] + flat.sizes[5]
    assert flat._cache_bytes == sum(v.nbytes for v in flat._cache.values())
    flat.points_of_blocks(np.array([5, 3, 5]))
    assert flat.gathered_rows == flat.sizes[3] + flat.sizes[5]


def test_localize_neighbors_matches_reference(small):
    x, y, _ = small
    rng = np.random.default_rng(4)
    neigh = [rng.choice(1500, size=k, replace=False) for k in (7, 1, 30, 0, 12)]
    got = st.localize_neighbors(MemoryStore(x, y), neigh)
    want = ref_st.localize_neighbors(MemoryStore(x, y), neigh)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


# -- the streaming fit -------------------------------------------------------


def test_streaming_fit_matches_reference(small, ref_store_dir):
    """The same reference-written store through both packages' streaming
    fits (the ``ref`` route: the checkpointed joint-assembly likelihood)."""
    kw = dict(inner_steps=4, outer_rounds=2, stream_chunk=400)
    want = ref_fit(ref_store.ArrayStore(ref_store_dir), None, RefConfig(**CFG), **kw)
    got = fit_sbv(ArrayStore(ref_store_dir), None, SBVConfig(**CFG), backend="ref",
                  device="cpu", **kw)
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    np.testing.assert_allclose(got.history[0][2], want.history[0][2], rtol=1e-10)
    np.testing.assert_allclose(_history(got), _history(want), rtol=1e-6)
    for a, b in zip(params_to_reference(got.params), _leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for k in ("n_chunks", "n_pieces", "packed_chunk_bytes_max", "spool_bytes", "bs_max", "bc"):
        assert got.stream_stats[k] == want.stream_stats[k], k
    assert got.stream_stats["n_chunks"] > 1


def test_streaming_fit_store_equals_incore(small, ref_store_dir):
    x, y, _ = small
    kw = dict(inner_steps=3, outer_rounds=2, stream_chunk=400, device="cpu")
    _assert_fits_equal(fit_sbv(ArrayStore(ref_store_dir), None, SBVConfig(**CFG), **kw),
                       fit_sbv(x, y, SBVConfig(**CFG), **kw))


@pytest.mark.parametrize("device_cache,prefetch", [("all", 0), ("all", 2), ("half", 2),
                                                   ("half", 0), (0, 2)])
def test_spool_tiers_and_prefetch_are_bitwise(small, device_cache, prefetch):
    """Device, mixed and disk tiers, prefetched or synchronous, against
    the disk tier read synchronously: the same fit, bit for bit."""
    x, y, _ = small
    cfg = SBVConfig(**CFG)
    kw = dict(inner_steps=3, outer_rounds=1, stream_chunk=300, device="cpu")
    base = fit_sbv(x, y, cfg, device_cache=0, prefetch=0, **kw)
    spool = base.stream_stats["spool_bytes"]
    budget = {"all": 1 << 30, "half": spool // 2}.get(device_cache, device_cache)
    got = fit_sbv(x, y, cfg, device_cache=budget, prefetch=prefetch, **kw)
    s = got.stream_stats
    assert s["n_pieces"] > 3
    if device_cache == "all":
        assert s["device_cached_pieces"] == s["n_pieces"] and s["h2d_bytes_per_step"] == 0
    elif device_cache == "half":
        assert 0 < s["device_cached_pieces"] < s["n_pieces"]
        assert 0 < s["h2d_bytes_per_step"] < spool
    else:
        assert s["device_cached_pieces"] == 0 and s["h2d_bytes_per_step"] == spool
    _assert_fits_equal(got, base)


def test_chunked_fit_matches_one_piece_1e10(small):
    x, y, _ = small
    kw = dict(inner_steps=4, outer_rounds=2, device="cpu")
    one = fit_sbv(x, y, SBVConfig(**CFG), stream_chunk=100_000, **kw)
    many = fit_sbv(x, y, SBVConfig(**CFG), stream_chunk=300, **kw)
    assert one.stream_stats["n_chunks"] == 1 and many.stream_stats["n_chunks"] > 3
    np.testing.assert_allclose(_history(many), _history(one), rtol=1e-10)
    for a, b in zip(many.params, one.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_bucketed_streaming_fit_matches_uniform(small):
    x, y, _ = small
    kw = dict(inner_steps=4, outer_rounds=1, stream_chunk=400, device="cpu")
    uni = fit_sbv(x, y, SBVConfig(**CFG), **kw)
    buck = fit_sbv(x, y, SBVConfig(**CFG), n_buckets=3, **kw)
    assert buck.stream_stats["n_pieces"] > uni.stream_stats["n_pieces"]
    np.testing.assert_allclose(_history(buck), _history(uni), rtol=1e-10)
    for a, b in zip(buck.params, uni.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


def test_bf16_streaming_pieces_are_bitwise_across_tiers(small):
    """bf16 pieces (torch.bfloat16 coordinates) through the disk tier's
    uint16 spool and the device tier give the same fit."""
    x, y, _ = small
    kw = dict(inner_steps=2, outer_rounds=1, stream_chunk=400, device="cpu", precision="bf16")
    disk = fit_sbv(x, y, SBVConfig(**CFG), device_cache=0, **kw)
    dev = fit_sbv(x, y, SBVConfig(**CFG), device_cache=1 << 30, **kw)
    assert disk.stream_stats["precision"] == "bf16" and disk.stream_stats["h2d_bytes_per_step"]
    _assert_fits_equal(dev, disk)


def test_streaming_fit_launches_the_kernel_route_per_piece(small, monkeypatch):
    """``backend='auto'`` goes through ``ops.sbv_loglik`` once per piece
    per step (on CUDA the kernel; here its plain version), and resolves
    per piece through ``ops.select_backend``."""
    x, y, _ = small
    calls = []
    real = ops.sbv_loglik
    monkeypatch.setattr(ops, "sbv_loglik", lambda *a, **k: calls.append(1) or real(*a, **k))
    r = fit_sbv(x, y, SBVConfig(**CFG), inner_steps=2, outer_rounds=2, stream_chunk=300,
                device="cpu")
    assert len(calls) == 2 * 2 * r.stream_stats["n_pieces"]
    assert ops.select_backend(r.stream_stats["bs_max"], 20, kind="loglik") == "auto"


def test_working_set_model_and_budget(small):
    x, y, _ = small
    res = fit_sbv(x, y, SBVConfig(**CFG), inner_steps=1, outer_rounds=1, stream_chunk=300,
                  device="cpu")
    s = res.stream_stats
    assert s["backward_blocks"] == ops.BACKWARD_CHUNK and s["backward_itemsize"] == 8
    ws = st.working_set_model(s, len(y), 4, 20, 300)
    assert all(v > 0 for v in ws["terms"].values())
    assert ws["total"] == sum(ws["terms"].values())
    assert ws["terms"]["device_grad"] == st.backward_live_bytes(s["bs_max"], 20,
                                                                ops.BACKWARD_CHUNK, d=4)
    assert ws["device_terms"] == {}
    want = st.stream_reserve_bytes(s["bs_max"], 20, 7, 1000, "auto", 2)
    assert want == (st.backward_live_bytes(s["bs_max"], 20, 7)
                    + 7 * (s["bs_max"] + 21) * (s["bs_max"] + 20) * 8 + 4 * 1000)
    assert 0 < s["device_reserve_bytes"] and s["device_cache_budget"] > 0
    assert st.device_cache_budget(reserve_bytes=1 << 62, device="cpu") == 0


# -- multi-output ------------------------------------------------------------


@pytest.fixture(scope="module")
def multi_problem():
    rng = np.random.default_rng(0)
    n, d, p = 500, 3, 3
    x = rng.uniform(size=(n, d))
    y = np.stack([np.sin(x @ rng.uniform(1.0, 3.0, size=d)) + 0.01 * rng.standard_normal(n)
                  for _ in range(p)], axis=1)
    return x, y


def test_multi_streaming_fit_matches_reference(multi_problem):
    x, y = multi_problem
    kw = dict(inner_steps=3, outer_rounds=1, stream_chunk=200)
    want = ref_fit(x, y, RefConfig(n_blocks=16, m=20, seed=0), backend="ref", **kw)
    got = fit_sbv(x, y, SBVConfig(n_blocks=16, m=20, seed=0), backend="ref", device="cpu", **kw)
    assert got.stream_stats["n_pieces"] == want.stream_stats["n_pieces"] > 1
    np.testing.assert_allclose(_history(got), _history(want), rtol=1e-8)
    for a, b in zip(multi_params_to_reference(got.params), _leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=1e-8)
    # The kernel route (its plain version here) and the disk tier agree.
    auto = fit_sbv(x, y, SBVConfig(n_blocks=16, m=20, seed=0), device="cpu", device_cache=0,
                   **kw)
    np.testing.assert_allclose(_history(auto), _history(want), rtol=1e-8)
    # One piece against many: the two-pass gradient is exact.
    one = fit_sbv(x, y, SBVConfig(n_blocks=16, m=20, seed=0), device="cpu",
                  **{**kw, "stream_chunk": 100_000})
    np.testing.assert_allclose(_history(auto), _history(one), rtol=1e-10)


def test_multi_streaming_counts_two_stats_passes(multi_problem, monkeypatch):
    x, y = multi_problem
    calls = []
    real = ops.sbv_multi_stats
    monkeypatch.setattr(ops, "sbv_multi_stats", lambda *a, **k: calls.append(1) or real(*a, **k))
    r = fit_sbv(x, y, SBVConfig(n_blocks=16, m=20, seed=0), inner_steps=2, outer_rounds=1,
                stream_chunk=200, device="cpu")
    pieces = r.stream_stats["n_pieces"]
    assert len(calls) == 2 * pieces * 2 + pieces
    with pytest.raises(NotImplementedError, match="bucketed"):
        fit_sbv(x, y, SBVConfig(n_blocks=16, m=20), stream_chunk=200, n_buckets=2, device="cpu")


# -- streaming prediction ----------------------------------------------------


def _ref_eps(seed):
    def eps(ci, bi, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ci)
        return np.asarray(jax.random.normal(key, shape, dtype=jnp.float64))
    return eps


def test_streaming_predict_matches_reference(tmp_path, small, ref_store_dir):
    """Against the reference at the generator's beta and sigma2 with
    nugget 1e-3: at its own nugget of 1e-8 the neighbour covariances are
    conditioned so that the in-core prediction too is only 7e-10 from the
    reference's (ROADMAP fault 2); the store-backed prediction is bitwise
    the in-core streaming one at both."""
    x, y, gen_p = small
    ref_p = RefParams.create(sigma2=float(gen_p.sigma2), beta=np.asarray(gen_p.beta),
                             nugget=1e-3)
    p = params_from_reference(*_leaves(ref_p))
    xt = np.random.default_rng(5).uniform(size=(300, 4))
    kw = dict(bs_pred=16, m_pred=48, n_sims=4, chunk_size=128, stream_chunk=400, seed=0)
    want = ref_predict(ref_p, ref_store.ArrayStore(ref_store_dir), None, xt, **kw)
    got = tpredict.predict_sbv(p, ArrayStore(ref_store_dir), None, xt, device="cpu",
                               eps=_ref_eps(0), **kw)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-10, atol=1e-10,
                                   err_msg=f)
    # Store-backed == in-core streaming, bitwise; a store x_test too.
    p = params_from_reference(*_leaves(gen_p))
    got = tpredict.predict_sbv(p, ArrayStore(ref_store_dir), None, xt, device="cpu",
                               eps=_ref_eps(0), **kw)
    mem = tpredict.predict_sbv(p, x, y, xt, device="cpu", eps=_ref_eps(0), **kw)
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        np.testing.assert_array_equal(getattr(got, f), getattr(mem, f), err_msg=f)
    st_t = ArrayStore.from_arrays(str(tmp_path / "pt"), xt, np.zeros(300), shard_rows=90)
    both = tpredict.predict_sbv(p, ArrayStore(ref_store_dir), None, st_t, device="cpu", **kw)
    np.testing.assert_array_equal(both.mean, mem.mean)
    np.testing.assert_array_equal(both.var, mem.var)
    # The index and the packed chunks are the reference's, bitwise.
    beta = np.asarray(gen_p.beta)
    ti = tpredict.build_train_index(x, y, beta, 48, stream_chunk=400)
    ri = ref_index(x, y, beta, 48, stream_chunk=400)
    assert ti.xs is None and ti.domain_volume == ri.domain_volume
    np.testing.assert_array_equal(ti.blocks.labels, ri.blocks.labels)
    from repro.core.predict import iter_query_chunks as ref_chunks

    for (_, a), (_, b) in zip(tpredict.iter_query_chunks(ti, st_t, 16, 48, chunk_size=128),
                              ref_chunks(ri, xt, 16, 48, chunk_size=128)):
        for f in ("q_x", "q_mask", "q_idx", "nn_x", "nn_y", "nn_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_streaming_predict_multi_output_matches_reference(multi_problem):
    x, y = multi_problem
    ref_p = ref_mo.MultiOutputParams.create(sigma2=[0.4, 0.7, 1.3], beta=[0.3, 0.5, 0.9],
                                            tau2=1e-3, d=3, p=3)
    from repro_torch.convert import multi_params_from_reference

    p = multi_params_from_reference(*_leaves(ref_p))
    xq = np.random.default_rng(7).uniform(size=(50, 3))
    kw = dict(bs_pred=8, m_pred=24, seed=3, n_sims=4, chunk_size=24, stream_chunk=150)
    want = ref_predict(ref_p, x, y, xq, **kw)
    got = tpredict.predict_sbv(p, x, y, xq, device="cpu", **kw)
    assert got.mean.shape == (50, 3)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.var, want.var, rtol=1e-10, atol=1e-12)


def test_streaming_predict_matches_exact_gp(small):
    x, y, ref_p = small
    x, y = x[:400], y[:400]
    xt = np.random.default_rng(2).uniform(size=(60, 4))
    pred = tpredict.predict_sbv(params_from_reference(*_leaves(ref_p)), x, y, xt, bs_pred=8,
                                m_pred=400, n_sims=2, stream_chunk=150, chunk_size=60,
                                device="cpu")
    em, ev = ref_exact_predict(ref_p, x, y, xt)
    np.testing.assert_allclose(pred.mean, np.asarray(em), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pred.var, np.asarray(ev), atol=1e-4, rtol=0)


# -- Nelder-Mead ------------------------------------------------------------


def test_fit_neldermead_matches_reference(small):
    """Same structure, same loss to ~1e-15, so the same simplex path: the
    final loss to rtol 1e-8 and the same iteration count."""
    x, y, _ = small
    x, y = x[:600], y[:600]
    cfg = dict(n_blocks=20, m=12, seed=0)
    want = ref_neldermead(x, y, RefConfig(**cfg), maxiter=60)
    got = fit_neldermead(x, y, SBVConfig(**cfg), maxiter=60, device="cpu")
    (_, it_got, loss_got), = got.history
    (_, it_want, loss_want), = want.history
    assert it_got == it_want, f"iterations: port {it_got}, reference {it_want}"
    np.testing.assert_allclose(loss_got, loss_want, rtol=1e-8)
    for a, b in zip(params_to_reference(got.params), _leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    for f in PACKED[:6]:
        np.testing.assert_array_equal(getattr(got.packed, f), getattr(want.packed, f))


# -- entry points ------------------------------------------------------------


def test_streaming_entry_points_need_a_device_without_cuda(small, monkeypatch):
    x, y, ref_p = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_sbv(MemoryStore(x, y), None, SBVConfig(**CFG), inner_steps=1, outer_rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_neldermead(x, y, SBVConfig(**CFG), maxiter=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.predict_sbv(params_from_reference(*_leaves(ref_p)), x, y, x[:20],
                             stream_chunk=300, bs_pred=4, m_pred=8)


@pytest.mark.parametrize("kw,item", [({"tuning": object()}, 11)])
def test_unported_streaming_options_name_their_roadmap_item(small, kw, item):
    """ROADMAP item 11 (tuning records) is ported: the streaming fit and
    prediction take a record, and a ``tuning`` that is no record is a
    ``TypeError`` naming what it expected."""
    x, y, ref_p = small
    with pytest.raises(TypeError, match="TuningRecord"):
        fit_sbv(x, y, SBVConfig(**CFG), stream_chunk=300, device="cpu", **kw)
    with pytest.raises(TypeError, match="TuningRecord"):
        tpredict.predict_sbv(params_from_reference(*_leaves(ref_p)), x, y, x[:20],
                             device="cpu", **kw)


# -- the joint-assembly likelihood (the streaming ref route's body) ----------


def test_joint_assembly_likelihood_matches_reference(small):
    """``block_loglik_joint`` and its checkpointed form against the
    reference's ``batched_block_loglik_joint[_remat]``: value rtol 1e-12,
    gradient rtol 1e-10; the same value as the chain form, and the
    multi-output remat stats as the reference's vmapped stats at the
    multi-output tests' stats tolerance, rtol 1e-10."""
    from repro.core import vecchia as ref_vecchia
    from repro.core.pipeline import preprocess as ref_preprocess
    from repro_torch.core import vecchia
    from repro_torch.core import multioutput as mo
    from repro_torch.convert import multi_params_from_reference

    x, y, ref_p = small
    ref_p = RefParams.create(sigma2=float(ref_p.sigma2), beta=np.asarray(ref_p.beta), nugget=1e-3)
    packed, _ = ref_preprocess(x[:600], y[:600], np.asarray(ref_p.beta), RefConfig(n_blocks=20,
                                                                                  m=16))
    arrs = vecchia.packed_arrays(packed, "cpu")
    rarrs = tuple(jnp.asarray(a) for a in (packed.blk_x, packed.blk_y, packed.blk_mask,
                                           packed.nn_x, packed.nn_y, packed.nn_mask))
    want = float(ref_vecchia.batched_block_loglik_joint(ref_p, *rarrs))
    assert float(ref_vecchia.batched_block_loglik_joint_remat(ref_p, *rarrs)) == pytest.approx(
        want, rel=1e-14)
    g_want = jax.grad(lambda q: ref_vecchia.batched_block_loglik_joint_remat(q, *rarrs))(ref_p)
    leaves = [t.requires_grad_(True) for t in params_from_reference(*_leaves(ref_p))]
    p = type(params_from_reference(*_leaves(ref_p)))(*leaves)
    got = vecchia.batched_block_loglik_joint_remat(p, *arrs, batch=7)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-12)
    with torch.no_grad():
        np.testing.assert_allclose(float(vecchia.batched_block_loglik_joint(p, *arrs)), want,
                                   rtol=1e-12)
        np.testing.assert_allclose(float(vecchia.batched_block_loglik(p, *arrs)), want,
                                   rtol=1e-12)
    for g, w in zip(torch.autograd.grad(got, leaves), _leaves(g_want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)
    # Multi-output: the checkpointed stats against the reference's.
    rng = np.random.default_rng(3)
    y3 = np.stack([y[:600], rng.normal(size=600), y[:600] ** 2], axis=1)
    mp_ref = ref_mo.MultiOutputParams.create(sigma2=[1.0, 0.5, 2.0], beta=np.asarray(ref_p.beta),
                                             tau2=1e-3, d=4, p=3)
    packed3, _ = ref_preprocess(x[:600], y3, np.asarray(ref_p.beta), RefConfig(n_blocks=20, m=16))
    ld_w, q_w = ref_mo.packed_multi_stats(mp_ref, packed3)
    p0 = multi_params_from_reference(*_leaves(mp_ref)).structure_params()
    ld, q = mo.batched_multi_stats_remat(p0, *vecchia.packed_arrays(packed3, "cpu"))
    np.testing.assert_allclose(float(ld), float(ld_w), rtol=1e-10)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_w), rtol=1e-10)


# -- the backward's live set: the reserve's count against a tally ------------


class _LiveBytes(TorchDispatchMode):
    """Tally of the bytes held by live CPU tensors, and its peak: every op's
    outputs are counted by storage until the last tensor on that storage
    is freed (saved tensors and the backward's temporaries included)."""

    def __init__(self):
        super().__init__()
        self.refs, self.size, self.live, self.peak = {}, {}, 0, 0

    def _drop(self, key):
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.live -= self.size.pop(key)
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr():
                key = t.untyped_storage().data_ptr()
                if key not in self.size:
                    self.size[key] = t.untyped_storage().nbytes()
                    self.live += self.size[key]
                self.refs[key] = self.refs.get(key, 0) + 1
                weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


@pytest.mark.parametrize("route,bc,bs,m,d,p", [
    ("auto", 8, 34, 40, 4, None), ("auto", 8, 60, 2, 4, None), ("auto", 8, 5, 60, 4, None),
    ("auto", 8, 34, 40, 37, None), ("auto", 8, 34, 40, 4, 1), ("auto", 8, 34, 40, 4, 32),
    ("auto", 8, 34, 40, 4, 148), ("auto", 8, 34, 40, 37, 8), ("auto", 1, 34, 40, 4, 8),
    ("ref", 16, 34, 40, 4, None), ("ref", 16, 34, 40, 4, 32)])
def test_backward_live_bytes_bounds_the_tally(route, bc, bs, m, d, p):
    """``backward_live_bytes`` (the streaming reserve's backward term) holds
    the tallied peak of one backward chunk's forward and backward, and is
    no more than twice it, across outputs, coordinates, bs / m balance,
    chunk sizes and both routes (p None: the single-output likelihood)."""
    from repro_torch.core.fit import _chunk_grad, _multi_stats_chunk, _multi_wgrad_chunk
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.core.multioutput import MultiOutputParams

    g = np.random.default_rng(0)
    u = lambda *s: torch.from_numpy(g.random(s))
    z = lambda *s: torch.from_numpy(g.standard_normal(s))
    obs = (bc, bs) if p is None else (bc, bs, p)
    arrs = (u(bc, bs, d), z(*obs), torch.ones(bc, bs, dtype=torch.bool), u(bc, m, d),
            z(bc, m, *obs[2:]), torch.ones(bc, m, dtype=torch.bool))
    with torch.no_grad():
        if p is None:
            prm = KernelParams(*(torch.as_tensor(a) for a in KernelParams.create(
                sigma2=1.0, beta=0.5, nugget=1e-3, d=d)))
        else:
            prm = MultiOutputParams(*(torch.as_tensor(a) for a in MultiOutputParams.create(
                sigma2=1.0, beta=0.5, tau2=1e-3, d=d, p=p)))
            w = 1.0 / _multi_stats_chunk(prm, arrs, 3.5, route)[1]
    with _LiveBytes() as tally:
        if p is None:
            _chunk_grad(prm, arrs, 3.5, route, 1000)
        else:
            _multi_wgrad_chunk(prm, w, arrs, 3.5, route, 1000, p)
    blocks = min(bc, ops.BACKWARD_CHUNK if route == "auto" else st.MAP_BATCH)
    model = st.backward_live_bytes(bs, m, blocks, 8, p or 1, d)
    assert tally.peak <= model <= 2 * tally.peak, (tally.peak, model)


def test_working_set_model_leaves_device_terms_out_on_cuda():
    s = dict(bs_max=169, packed_chunk_bytes_max=7 << 20, backward_blocks=ops.BACKWARD_CHUNK,
             backward_itemsize=8, bc=2000, spool_bytes=72 << 20, device_cached_bytes=36 << 20,
             n_outputs=32)
    cpu = st.working_set_model(s, 200_000, 10, 200, 65536, n_caches=1)
    cuda = st.working_set_model(s, 200_000, 10, 200, 65536, n_caches=1, device="cuda")
    assert set(cuda["device_terms"]) == {"device_grad", "device_spool"}
    assert cuda["terms"] == {k: v for k, v in cpu["terms"].items() if k not in cuda["device_terms"]}
    assert cuda["total"] + sum(cuda["device_terms"].values()) == cpu["total"]
    assert cpu["terms"]["device_grad"] == st.backward_live_bytes(169, 200, ops.BACKWARD_CHUNK,
                                                                 8, 32, 10)
