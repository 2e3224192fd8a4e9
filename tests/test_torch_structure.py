"""Port vs reference: host-side structure is bitwise identical.

``preprocess`` (scaling, RAC, ordering, filtered NNS, packing) and
``pack_queries`` are numpy copies in the port; the same seeds must give
identical blocks, neighbour lists and packed arrays.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import predict as ref_predict  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import predict  # noqa: E402

PACKED_FIELDS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask", "owners")
PRED_FIELDS = ("q_x", "q_mask", "q_idx", "nn_x", "nn_y", "nn_mask", "owners")


def _data(seed, n, d=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, d)), rng.normal(size=n), np.linspace(0.3, 2.0, d)


@pytest.mark.parametrize("seed,n,bc,m,kw", [
    (0, 120, 12, 10, {}),
    (1, 97, 9, 7, {}),                                # ragged n
    (2, 150, 15, 12, {"n_workers": 3, "ordering": "maxmin"}),
    (3, 80, 8, 6, {"nns": "brute", "clustering": "kmeans", "ordering": "coord"}),
])
def test_preprocess_bitwise(seed, n, bc, m, kw):
    x, y, beta = _data(seed, n)
    got, gb = pipeline.preprocess(x, y, beta, pipeline.SBVConfig(n_blocks=bc, m=m, seed=seed, **kw))
    want, wb = ref_pipeline.preprocess(x, y, beta,
                                       ref_pipeline.SBVConfig(n_blocks=bc, m=m, seed=seed, **kw))
    for f in PACKED_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(gb.labels, wb.labels)
    np.testing.assert_array_equal(gb.order, wb.order)
    np.testing.assert_array_equal(gb.centers, wb.centers)


@pytest.mark.parametrize("seed,n_test,pad", [(0, 53, False), (1, 64, True)])
def test_pack_queries_bitwise(seed, n_test, pad):
    x, y, beta = _data(seed, 150)
    x_test = np.random.default_rng(seed + 10).uniform(size=(n_test, 3))
    idx = predict.build_train_index(x, y, beta, m_pred=12, seed=seed)
    ridx = ref_predict.build_train_index(x, y, beta, m_pred=12, seed=seed)
    got = predict.pack_queries(idx, x_test, 5, 12, seed=seed, offset=7, pad_shapes=pad)
    want = ref_predict.pack_queries(ridx, x_test, 5, 12, seed=seed, offset=7, pad_shapes=pad)
    for f in PRED_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_iter_query_chunks_bitwise():
    x, y, beta = _data(4, 150)
    x_test = np.random.default_rng(5).uniform(size=(70, 3))
    idx = predict.build_train_index(x, y, beta, m_pred=10)
    ridx = ref_predict.build_train_index(x, y, beta, m_pred=10)
    got = list(predict.iter_query_chunks(idx, x_test, 4, 10, chunk_size=30))
    want = list(ref_predict.iter_query_chunks(ridx, x_test, 4, 10, chunk_size=30))
    assert [c for c, _ in got] == [c for c, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(got, want):
        for f in PRED_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_packing_rejects_sentinel_neighbors():
    from repro_torch.core.packing import _check_neighbors

    with pytest.raises(ValueError):
        _check_neighbors(np.array([3, -1]), 0, 10)
    with pytest.raises(ValueError):
        _check_neighbors(np.array([3, 3]), 0, 10)
    np.testing.assert_array_equal(_check_neighbors(np.array([1, 2]), 0, 10), [1, 2])


@pytest.mark.parametrize("p,days", [(1, 100), (7, 100), (32, 100), (250, 100), (5, 0)])
def test_metarvm_field_generators_bitwise(p, days):
    """The port takes all p snapshots from one daily sweep; every column is
    bitwise the reference's separate run of that many days."""
    from repro.data import gp_sim as ref_sim
    from repro_torch.data import gp_sim

    theta = gp_sim.metarvm_sample_inputs(3, 40)
    np.testing.assert_array_equal(theta, ref_sim.metarvm_sample_inputs(3, 40))
    np.testing.assert_array_equal(gp_sim.metarvm_field_simulate(theta, p, days=days),
                                  ref_sim.metarvm_field_simulate(theta, p, days=days))
    gx, gy = gp_sim.metarvm_field_dataset(4, 60, p, days=days)
    rx, ry = ref_sim.metarvm_field_dataset(4, 60, p, days=days)
    np.testing.assert_array_equal(gx, rx)
    np.testing.assert_array_equal(gy, ry)


def test_metarvm_and_satellite_generators_bitwise():
    from repro.data import gp_sim as ref_sim
    from repro_torch.data import gp_sim

    theta = gp_sim.metarvm_sample_inputs(5, 30)
    np.testing.assert_array_equal(gp_sim.metarvm_simulate(theta),
                                  ref_sim.metarvm_simulate(theta))
    np.testing.assert_array_equal(gp_sim.metarvm_simulate(theta[0], days=37),
                                  ref_sim.metarvm_simulate(theta[0], days=37))
    for normalize in (True, False):
        for a, b in zip(gp_sim.metarvm_dataset(6, 50, normalize=normalize),
                        ref_sim.metarvm_dataset(6, 50, normalize=normalize)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(gp_sim.satellite_drag_like(7, 80), ref_sim.satellite_drag_like(7, 80)):
        np.testing.assert_array_equal(a, b)
    assert gp_sim.METARVM_BOUNDS == ref_sim.METARVM_BOUNDS
    with pytest.raises(ValueError):
        gp_sim.metarvm_field_simulate(theta, 0)
