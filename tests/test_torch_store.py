"""Port vs reference: the row store, the prefetcher, the RSS sampler and the
spool's host side, on the CPU.

The store's on-disk format is the reference's, so a store written by
either package reads in the other, row for row. The prefetcher keeps the
reference's contract (order, bounded depth, errors surface in the
consumer, close joins). A spooled piece round-trips bit for bit through
either tier, bf16 coordinates included, and its ``.npz`` reads in the
reference's spool.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import store as ref_store  # noqa: E402
from repro.data import streaming as ref_streaming  # noqa: E402
from repro.data.gp_sim import paper_synthetic  # noqa: E402
from repro_torch.core.packing import PackedBlocks  # noqa: E402
from repro_torch.data import store as tstore  # noqa: E402
from repro_torch.data.store import ArrayStore, MemoryStore, as_store, is_store  # noqa: E402
from repro_torch.data.streaming import PackedChunkSpool  # noqa: E402
from repro_torch.memwatch import PeakRssSampler  # noqa: E402
from repro_torch.prefetch import Prefetcher  # noqa: E402


@pytest.fixture(scope="module")
def small():
    x, y, _ = paper_synthetic(seed=0, n=1500, d=4)
    return x, y


def test_store_roundtrip_and_gather(tmp_path, small):
    x, y = small
    st = ArrayStore.from_arrays(str(tmp_path / "s"), x, y, shard_rows=400)
    assert (st.n_rows, st.d, st.n_shards) == (1500, 4, 4)
    st.verify()
    xa, ya = st.read_all()
    assert np.array_equal(xa, x) and np.array_equal(ya, y)
    idx = np.array([1499, 0, 401, 400, 399, 401])
    xg, yg = st.read_rows(idx)
    assert np.array_equal(xg, x[idx]) and np.array_equal(yg, y[idx])
    with pytest.raises(IndexError):
        st.read_rows(np.array([1500]))
    assert is_store(st) and is_store(MemoryStore(x, y)) and not is_store(x)
    assert as_store(st) is st
    with pytest.raises(ValueError, match="y=None"):
        as_store(st, y)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, small, writer):
    """The same directory through both readers: manifest, shards, windows,
    gathers and a multi-output (n, p) store, row for row."""
    x, y = small
    y2 = np.stack([y, 2.0 * y], axis=1)
    w, r = (ref_store, tstore) if writer == "reference" else (tstore, ref_store)
    for name, yy in (("one", y), ("multi", y2)):
        path = str(tmp_path / name)
        w.ArrayStore.from_arrays(path, x, yy, shard_rows=317)
        got, want = r.ArrayStore(path), w.ArrayStore(path)
        assert (got.n_rows, got.d, got.n_shards, got.shard_rows, got.dtype) == \
            (want.n_rows, want.d, want.n_shards, want.shard_rows, want.dtype)
        if yy.ndim == 1:
            got.verify()
        for (a0, xa, ya), (b0, xb, yb) in zip(got.iter_chunks(700), want.iter_chunks(700)):
            assert a0 == b0 and np.array_equal(xa, xb) and np.array_equal(ya, yb)
        idx = np.array([5, 1499, 316, 317, 0])
        # The reference's gather allocates (k,) observations, so only the
        # port's reads an (n, p) store's rows (ROADMAP fault 6).
        reader = got if r is tstore else want
        for a, b in zip(reader.read_rows(idx), (x[idx], yy[idx])):
            assert np.array_equal(a, b)
        if yy.ndim == 2:
            with pytest.raises(ValueError, match="broadcast"):
                ref_store.ArrayStore(path).read_rows(idx)
            tstore.ArrayStore(path).verify()


def test_writer_appends_span_shards(tmp_path, small):
    x, y = small
    with ArrayStore.create(str(tmp_path / "w"), 4, shard_rows=512) as w:
        for a in range(0, 1500, 613):  # deliberately shard-misaligned
            w.append(x[a:a + 613], y[a:a + 613])
    st = ArrayStore(str(tmp_path / "w"))
    assert st.n_rows == 1500 and st.n_shards == 3
    xa, ya = st.read_all()
    assert np.array_equal(xa, x) and np.array_equal(ya, y)
    with pytest.raises(RuntimeError, match="finalized"):
        w.append(x[:1], y[:1])


def test_manifest_integrity_checks(tmp_path, small):
    x, y = small
    path = str(tmp_path / "m")
    ArrayStore.from_arrays(path, x, y, shard_rows=400)
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m["n_rows"] = 9999
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="corrupt manifest"):
        ArrayStore(path)
    m["n_rows"] = 1500
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(m, f)
    os.remove(os.path.join(path, "x_00002.npy"))
    with pytest.raises(FileNotFoundError, match="missing shards"):
        ArrayStore(path)
    with pytest.raises(FileNotFoundError):
        ArrayStore(str(tmp_path / "not-a-store"))


def test_iter_chunks_boundaries(tmp_path, small):
    x, y = small
    st = ArrayStore.from_arrays(str(tmp_path / "c"), x, y, shard_rows=400)
    ws = list(st.iter_chunks(700))
    assert [w[0] for w in ws] == [0, 700, 1400]
    assert [w[1].shape[0] for w in ws] == [700, 700, 100]
    assert np.array_equal(np.concatenate([w[1] for w in ws]), x)
    ws = list(st.iter_chunks(10_000))
    assert len(ws) == 1 and ws[0][1].shape[0] == 1500
    assert [w[1].shape[0] for w in st.iter_chunks()] == [400, 400, 400, 300]
    ws_m = list(MemoryStore(x, y).iter_chunks(700))
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
               for a, b in zip(st.iter_chunks(700), ws_m))


def test_rows_view_scalar_indexing(tmp_path, small):
    x, y = small
    st = ArrayStore.from_arrays(str(tmp_path / "rv"), x, y, shard_rows=400)
    xv, yv = st.x_rows, st.y_rows
    assert xv.shape == (1500, 4) and len(yv) == 1500
    assert xv[5].shape == (4,) and np.array_equal(xv[5], x[5])
    assert np.ndim(yv[5]) == 0 and yv[5] == y[5]
    assert np.array_equal(xv[-1], x[-1]) and yv[-1] == y[-1]
    assert xv[np.array([5])].shape == (1, 4) and xv[10:12].shape == (2, 4)
    with pytest.raises(IndexError):
        xv[len(xv)]
    with pytest.raises(IndexError):
        xv[::2]


@pytest.mark.parametrize("n_parts,align", [(3, None), (4, 1), (7, 100)])
def test_partitioned_store_matches_reference(tmp_path, small, n_parts, align):
    x, y = small
    path = str(tmp_path / "pt")
    ArrayStore.from_arrays(path, x, y, shard_rows=400)
    np.testing.assert_array_equal(tstore.partition_bounds(1500, n_parts, align or 1),
                                  ref_store.partition_bounds(1500, n_parts, align or 1))
    windows = []
    for part in range(n_parts):
        got = tstore.PartitionedStore(ArrayStore(path), n_parts, part, align=align)
        want = ref_store.PartitionedStore(ref_store.ArrayStore(path), n_parts, part, align=align)
        assert (got.start, got.stop, got.n_local) == (want.start, want.stop, want.n_local)
        for (a0, xa, ya), (b0, xb, yb) in zip(got.iter_chunks(256), want.iter_chunks(256)):
            assert a0 == b0 and np.array_equal(xa, xb) and np.array_equal(ya, yb)
            windows.append((a0, xa.shape[0]))
        idx = np.array([0, 1499, 700])
        got.read_rows(idx)
        want.read_rows(idx)
        assert got.remote_rows_read == want.remote_rows_read
    # The union of the parts' windows is the whole store, once.
    assert sum(k for _, k in windows) == 1500
    with pytest.raises(ValueError):
        tstore.PartitionedStore(MemoryStore(x, y), 2, 2)


def test_prefetcher_propagates_errors_and_closes():
    def boom():
        yield 1
        raise RuntimeError("producer failed")

    with Prefetcher(boom(), depth=1) as pf:
        it = iter(pf)
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="producer failed"):
            next(it)
    # Early close unblocks a producer stuck on a full queue.
    pf = Prefetcher(iter(range(100)), depth=1, stage=lambda i: i * 2)
    assert next(iter(pf)) == 0
    pf.close()
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())
    # Order is kept and every item is staged.
    with Prefetcher(iter(range(50)), depth=3, stage=lambda i: i * i) as pf:
        assert list(pf) == [i * i for i in range(50)]


def test_prefetcher_iteration_terminates_after_close():
    pf = Prefetcher(iter(range(100)), depth=1)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    done = {}
    th = threading.Thread(target=lambda: done.setdefault("items", list(it)), daemon=True)
    th.start()
    th.join(timeout=10.0)
    assert "items" in done, "iteration did not terminate after close()"

    def boom():
        raise RuntimeError("producer failed")
        yield  # pragma: no cover

    pf2 = Prefetcher(boom(), depth=1)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(iter(pf2))
    assert list(iter(pf2)) == []
    pf2.close()


def test_peak_rss_sampler_sees_an_allocation():
    if not os.path.exists("/proc/self/status"):
        pytest.skip("no /proc/self/status on this platform")
    s = PeakRssSampler(interval_s=0.001).start()
    buf = np.ones(64 << 20, dtype=np.uint8)  # 64 MiB, touched
    delta = s.stop()
    assert delta is not None and delta >= 32 << 20
    del buf


def _piece(seed=0, bc=3, bs=5, m=4, d=2, bf16=False):
    rng = np.random.default_rng(seed)
    x = lambda *s: rng.normal(size=s)
    pk = PackedBlocks(blk_x=x(bc, bs, d), blk_y=x(bc, bs), blk_mask=rng.uniform(size=(bc, bs)) > .3,
                      nn_x=x(bc, m, d), nn_y=x(bc, m), nn_mask=rng.uniform(size=(bc, m)) > .3,
                      owners=np.zeros(bc, np.int32))
    if bf16:
        from repro_torch.core.buckets import cast_packed

        pk = cast_packed(pk, "bf16")
    return pk


def _same(a, b):
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_spool_tiers_round_trip_in_add_order(tmp_path, bf16):
    """Half the pieces on the device tier, half on disk: every piece comes
    back bit for bit in add order, with and without the prefetch thread;
    bf16 coordinates come back as torch.bfloat16."""
    pieces = [_piece(seed=i, bf16=bf16) for i in range(4)]
    keys = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask")
    nb = sum(int(np.asarray(getattr(pieces[0], k)).nbytes) if not isinstance(
        getattr(pieces[0], k), torch.Tensor) else getattr(pieces[0], k).numel() * 2
        for k in keys)
    sp = PackedChunkSpool(str(tmp_path / "sp"), device_budget=2 * nb, device="cpu")
    for i, pk in enumerate(pieces):
        sp.add(pk, tag=i)
    assert (sp.n_device, sp.n_disk) == (2, 2) and sp.disk_bytes_total == 2 * nb
    for prefetch in (0, 2):
        got = list(sp.iter_arrays(prefetch=prefetch))
        assert [t for _, t in got] == [0, 1, 2, 3]
        for (arrs, _), pk in zip(got, pieces):
            assert all(_same(a, getattr(pk, k)) for a, k in zip(arrs, keys))
            assert (arrs[0].dtype == torch.bfloat16) == bf16
    sp.cleanup()
    assert len(sp) == 0 and not os.path.exists(sp.path)


def test_spool_reusable_after_cleanup_and_add_arrays(tmp_path):
    sp = PackedChunkSpool(str(tmp_path / "sp"), device_budget=0, device="cpu")
    sp.add(_piece())
    sp.cleanup()
    assert sp.device_bytes == 0 and sp.disk_bytes_total == 0
    sp.add(_piece())
    assert len(list(sp.iter_arrays(prefetch=0))) == 1
    bundle = {"mean": np.arange(6.0), "idx": np.arange(6), "z": torch.ones(3, dtype=torch.bfloat16)}
    sp.add_arrays(bundle, tag="sink")
    arrs, tag = list(sp.iter_arrays(prefetch=2))[1]
    assert tag == "sink" and set(arrs) == set(bundle)
    assert all(_same(arrs[k], bundle[k]) for k in bundle)
    host = PackedChunkSpool(str(tmp_path / "host"), device_budget=0, device_stage=False)
    host.add_arrays(bundle)
    (arrs, _), = host.iter_arrays(prefetch=0)
    assert isinstance(arrs["mean"], np.ndarray) and np.array_equal(arrs["mean"], bundle["mean"])
    sp.cleanup()
    host.cleanup()


@pytest.mark.parametrize("bf16", [False, True])
def test_spooled_piece_reads_in_the_reference_spool(tmp_path, bf16):
    """The disk tier's .npz is the reference's layout: its reader returns
    the same bits (bf16 through its ``__bf16__`` uint16 convention)."""
    pk = _piece(seed=3, bf16=bf16)
    sp = PackedChunkSpool(str(tmp_path / "sp"), device_budget=0, device="cpu")
    sp.add(pk)
    path = sp._entries[0][1]
    with np.load(path) as z:
        for k in ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask"):
            got = ref_streaming._npz_read(z, k)
            want = getattr(pk, k)
            if isinstance(want, torch.Tensor):
                want = want.view(torch.int16).numpy()
                got = got.view(np.int16)
            assert got.dtype == want.dtype and np.array_equal(got, want), k
        assert np.array_equal(z["owners"], pk.owners)
    sp.cleanup()
