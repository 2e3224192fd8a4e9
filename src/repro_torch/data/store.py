"""Sharded on-disk array store for out-of-core SBV datasets.

A numpy copy of ``repro.data.store``: the on-disk format (``.npy`` shards
plus ``manifest.json``) is the reference's, so a store written by either
package reads in the other.

The paper's headline runs (50M-point respiratory emulation, 2.56B points
across 512 GPUs) only work because every pipeline stage streams through
bounded device memory. This module is the host-side half of that story:
a dataset is a DIRECTORY of fixed-size ``.npy`` row shards plus a small
JSON manifest, and consumers read it through three bounded primitives —

* ``iter_chunks(rows)``   — sequential windows of at most ``rows`` rows
  (windows may span shards; only the shards a window touches are read);
* ``read_slice(a, b)``    — one explicit window;
* ``read_rows(idx)``      — random-access gather of arbitrary row indices,
  grouped by shard and served through short-lived memory maps so the
  resident set stays bounded by the gather size, not the file size.

Shards are plain ``.npy`` files so every chunk is debuggable with nothing
but numpy, and float64 rows round-trip bit-exactly — which is what makes
the store-backed fit/predict paths *bitwise* equal to their in-core
twins (tests/test_torch_streaming.py).

``MemoryStore`` is the in-RAM implementation of the same protocol: the
streaming construction code is written against the protocol, so "in-core"
vs "out-of-core" differ only in where the bytes live.
"""
from __future__ import annotations

import json
import os

import numpy as np

MANIFEST = "manifest.json"
DEFAULT_SHARD_ROWS = 131072


def is_store(obj) -> bool:
    """True for anything speaking the row-store protocol (duck-typed)."""
    return all(hasattr(obj, a) for a in ("n_rows", "d", "iter_chunks", "read_rows"))


def as_store(x, y=None):
    """Coerce ``(x, y)`` arrays to a ``MemoryStore``; pass stores through."""
    if is_store(x):
        if y is not None:
            raise ValueError("pass y=None when x is already a store")
        return x
    return MemoryStore(x, y)


class MemoryStore:
    """In-RAM twin of ``ArrayStore`` (same read protocol, zero IO)."""

    def __init__(self, x: np.ndarray, y: np.ndarray | None):
        self.x = np.asarray(x, dtype=np.float64)
        if self.x.ndim != 2:
            raise ValueError(f"x must be (n, d), got shape {self.x.shape}")
        self.y = (np.zeros(self.x.shape[0]) if y is None
                  else np.asarray(y, dtype=np.float64))
        # (n,) single-output or (n, p) multi-output observation rows.
        if self.y.ndim not in (1, 2) or self.y.shape[0] != self.x.shape[0]:
            raise ValueError(f"y must be ({self.x.shape[0]},) or "
                             f"({self.x.shape[0]}, p), got {self.y.shape}")

    @property
    def n_rows(self) -> int:
        return self.x.shape[0]

    @property
    def d(self) -> int:
        return self.x.shape[1]

    @property
    def dtype(self):
        return self.x.dtype

    @property
    def x_rows(self):
        return self.x

    @property
    def y_rows(self):
        return self.y

    def read_slice(self, start: int, stop: int):
        return self.x[start:stop], self.y[start:stop]

    def read_rows(self, idx: np.ndarray):
        idx = np.asarray(idx, dtype=np.int64)
        return self.x[idx], self.y[idx]

    def read_all(self):
        return self.x, self.y

    def iter_chunks(self, rows: int | None = None):
        n = self.n_rows
        rows = n if rows is None else max(1, int(rows))
        for start in range(0, n, rows):
            stop = min(n, start + rows)
            yield start, self.x[start:stop], self.y[start:stop]


class ArrayStoreWriter:
    """Append-only writer; ``finalize()`` seals the manifest.

    Rows are buffered to at most one shard and flushed as ``.npy`` files,
    so writing an arbitrarily large dataset needs ~one shard of RAM.
    """

    def __init__(self, path: str, d: int, dtype="float64",
                 shard_rows: int = DEFAULT_SHARD_ROWS):
        self.path = path
        self.d = int(d)
        self.dtype = np.dtype(dtype)
        self.shard_rows = int(shard_rows)
        if self.shard_rows <= 0:
            raise ValueError("shard_rows must be positive")
        os.makedirs(path, exist_ok=True)
        self._shards: list[dict] = []
        self._buf_x: list[np.ndarray] = []
        self._buf_y: list[np.ndarray] = []
        self._buf_rows = 0
        self._finalized = False

    def append(self, x: np.ndarray, y: np.ndarray) -> None:
        if self._finalized:
            raise RuntimeError("writer already finalized")
        x = np.ascontiguousarray(x, dtype=self.dtype)
        y = np.ascontiguousarray(y, dtype=self.dtype)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (k, {self.d}) rows, got {x.shape}")
        if y.ndim not in (1, 2) or y.shape[0] != x.shape[0]:
            raise ValueError(f"y shape {y.shape} != ({x.shape[0]},) or "
                             f"({x.shape[0]}, p)")
        self._buf_x.append(x)
        self._buf_y.append(y)
        self._buf_rows += x.shape[0]
        while self._buf_rows >= self.shard_rows:
            self._flush(self.shard_rows)

    def _flush(self, rows: int) -> None:
        if rows <= 0:
            return
        x = np.concatenate(self._buf_x) if len(self._buf_x) != 1 else self._buf_x[0]
        y = np.concatenate(self._buf_y) if len(self._buf_y) != 1 else self._buf_y[0]
        head_x, tail_x = x[:rows], x[rows:]
        head_y, tail_y = y[:rows], y[rows:]
        i = len(self._shards)
        x_name, y_name = f"x_{i:05d}.npy", f"y_{i:05d}.npy"
        np.save(os.path.join(self.path, x_name), head_x)
        np.save(os.path.join(self.path, y_name), head_y)
        self._shards.append({"rows": int(head_x.shape[0]), "x": x_name, "y": y_name})
        self._buf_x = [tail_x] if tail_x.shape[0] else []
        self._buf_y = [tail_y] if tail_y.shape[0] else []
        self._buf_rows = int(tail_x.shape[0])

    def finalize(self) -> "ArrayStore":
        if self._finalized:
            raise RuntimeError("writer already finalized")
        if self._buf_rows:
            self._flush(self._buf_rows)
        manifest = {
            "version": 1,
            "n_rows": int(sum(s["rows"] for s in self._shards)),
            "d": self.d,
            "dtype": self.dtype.name,
            "shard_rows": self.shard_rows,
            "shards": self._shards,
        }
        with open(os.path.join(self.path, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        self._finalized = True
        return ArrayStore(self.path)

    def __enter__(self) -> "ArrayStoreWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.finalize()


class _RowsView:
    """Lazy fancy-indexable view of one field of a store.

    Quacks enough like an ``(n,)``/``(n, d)`` ndarray — ``.shape`` plus
    ``view[idx]`` gathers — for code written against in-core arrays
    (``pack_prediction``, ``GPServer``) to run unchanged on a store.
    """

    def __init__(self, store, field: str):
        self._store = store
        self._field = field

    @property
    def shape(self) -> tuple:
        if self._field == "x":
            return (self._store.n_rows, self._store.d)
        return (self._store.n_rows,)

    def __len__(self) -> int:
        return self._store.n_rows

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._store.n_rows)
            if step != 1:
                raise IndexError("strided slices are not supported on stores")
            x, y = self._store.read_slice(start, stop)
            return x if self._field == "x" else y
        idx = np.asarray(idx, np.int64)
        if idx.ndim == 0:
            # Scalar index: ndarray semantics drop the row axis —
            # ``view[5]`` is ``(d,)``/scalar, not ``(1, d)``/``(1,)``.
            i = int(idx)
            if i < 0:
                i += self._store.n_rows
            if not 0 <= i < self._store.n_rows:
                raise IndexError(
                    f"row index {int(idx)} outside [0, {self._store.n_rows})")
            x, y = self._store.read_rows(np.asarray([i], np.int64))
            return x[0] if self._field == "x" else y[0]
        x, y = self._store.read_rows(idx)
        return x if self._field == "x" else y


class ArrayStore:
    """Reader over a finalized store directory (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        mpath = os.path.join(path, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(f"no {MANIFEST} in {path!r} — not a store?")
        with open(mpath) as f:
            m = json.load(f)
        if m.get("version") != 1:
            raise ValueError(f"unsupported store version {m.get('version')!r}")
        self._m = m
        self._rows = np.asarray([s["rows"] for s in m["shards"]], dtype=np.int64)
        self._starts = np.concatenate([[0], np.cumsum(self._rows)])
        if int(self._starts[-1]) != int(m["n_rows"]):
            raise ValueError(
                f"manifest n_rows={m['n_rows']} != sum of shard rows "
                f"{int(self._starts[-1])} — corrupt manifest"
            )
        missing = [s[f] for s in m["shards"] for f in ("x", "y")
                   if not os.path.exists(os.path.join(path, s[f]))]
        if missing:
            raise FileNotFoundError(f"store {path!r} is missing shards: {missing}")

    # -- metadata ------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return int(self._m["n_rows"])

    @property
    def d(self) -> int:
        return int(self._m["d"])

    @property
    def dtype(self):
        return np.dtype(self._m["dtype"])

    @property
    def n_shards(self) -> int:
        return len(self._m["shards"])

    @property
    def shard_rows(self) -> int:
        return int(self._m["shard_rows"])

    @property
    def x_rows(self) -> _RowsView:
        return _RowsView(self, "x")

    @property
    def y_rows(self) -> _RowsView:
        return _RowsView(self, "y")

    def verify(self) -> None:
        """Check every shard's npy header against the manifest."""
        for i, s in enumerate(self._m["shards"]):
            x = np.load(os.path.join(self.path, s["x"]), mmap_mode="r")
            y = np.load(os.path.join(self.path, s["y"]), mmap_mode="r")
            if x.shape != (s["rows"], self.d) or y.shape[:1] != (s["rows"],) or y.ndim > 2:
                raise ValueError(
                    f"shard {i}: shapes x={x.shape} y={y.shape} disagree with "
                    f"manifest rows={s['rows']} d={self.d}"
                )
            if x.dtype != self.dtype or y.dtype != self.dtype:
                raise ValueError(f"shard {i}: dtype {x.dtype}/{y.dtype} != {self.dtype}")
            del x, y  # unmap promptly

    # -- reads ---------------------------------------------------------

    def _shard_arrays(self, i: int):
        """Short-lived memory maps of shard i (caller must drop refs)."""
        s = self._m["shards"][i]
        x = np.load(os.path.join(self.path, s["x"]), mmap_mode="r")
        y = np.load(os.path.join(self.path, s["y"]), mmap_mode="r")
        return x, y

    def read_slice(self, start: int, stop: int):
        """Rows [start, stop) as in-core arrays (copies; maps are dropped)."""
        start = max(0, int(start))
        stop = min(self.n_rows, int(stop))
        if stop <= start:
            return (np.empty((0, self.d), self.dtype), np.empty(0, self.dtype))
        s0 = int(np.searchsorted(self._starts, start, side="right") - 1)
        s1 = int(np.searchsorted(self._starts, stop, side="left"))
        xs, ys = [], []
        for i in range(s0, s1):
            a = max(start, int(self._starts[i])) - int(self._starts[i])
            b = min(stop, int(self._starts[i + 1])) - int(self._starts[i])
            sx, sy = self._shard_arrays(i)
            xs.append(np.array(sx[a:b]))
            ys.append(np.array(sy[a:b]))
            del sx, sy
        if len(xs) == 1:
            return xs[0], ys[0]
        return np.concatenate(xs), np.concatenate(ys)

    def read_rows(self, idx: np.ndarray):
        """Gather arbitrary rows, preserving the requested order.

        Indices are grouped by shard and read through short-lived memory
        maps; sorting within each shard keeps the page access sequential.
        """
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 1:
            raise ValueError(f"read_rows wants a 1-D index array, got {idx.shape}")
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= self.n_rows):
            raise IndexError(f"row index outside [0, {self.n_rows})")
        x = np.empty((idx.size, self.d), dtype=self.dtype)
        if self.n_shards == 0:
            return x, np.empty(idx.size, dtype=self.dtype)
        # (n,) or (n, p) observation rows: the shards' trailing shape (the
        # reference allocates (k,) here, so its gather of an (n, p) store
        # fails).
        y = np.empty((idx.size,) + self._shard_arrays(0)[1].shape[1:], dtype=self.dtype)
        if idx.size == 0:
            return x, y
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        for i in np.unique(shard_of):
            where = np.nonzero(shard_of == i)[0]
            local = idx[where] - int(self._starts[i])
            order = np.argsort(local, kind="stable")
            sx, sy = self._shard_arrays(int(i))
            x[where[order]] = sx[local[order]]
            y[where[order]] = sy[local[order]]
            del sx, sy
        return x, y

    def read_all(self):
        return self.read_slice(0, self.n_rows)

    def iter_chunks(self, rows: int | None = None):
        """Yield ``(start, x_window, y_window)`` sequential windows.

        ``rows=None`` uses the manifest shard size. The last window is
        ragged (``n_rows % rows`` rows) unless rows divides n_rows.
        """
        rows = int(self._m["shard_rows"]) if rows is None else max(1, int(rows))
        for start in range(0, self.n_rows, rows):
            stop = min(self.n_rows, start + rows)
            x, y = self.read_slice(start, stop)
            yield start, x, y

    # -- construction --------------------------------------------------

    @classmethod
    def create(cls, path: str, d: int, dtype="float64",
               shard_rows: int = DEFAULT_SHARD_ROWS) -> ArrayStoreWriter:
        return ArrayStoreWriter(path, d, dtype=dtype, shard_rows=shard_rows)

    @classmethod
    def from_arrays(cls, path: str, x: np.ndarray, y: np.ndarray,
                    shard_rows: int = DEFAULT_SHARD_ROWS) -> "ArrayStore":
        x = np.asarray(x)
        with cls.create(path, x.shape[1], dtype=x.dtype, shard_rows=shard_rows) as w:
            w.append(x, np.asarray(y, dtype=x.dtype))
        return cls(path)


def partition_bounds(n_rows: int, n_parts: int, align: int = 1) -> np.ndarray:
    """Row boundaries of an even, ``align``-multiple partition of ``n_rows``.

    Returns ``(n_parts + 1,)`` monotone bounds with part p owning
    ``[bounds[p], bounds[p + 1])``. Boundaries snap to multiples of
    ``align`` (shard size for an ``ArrayStore``: a host then only touches
    its own shard files on sequential passes) except the final bound,
    which is always ``n_rows``. Tail parts may be empty when
    ``n_rows < n_parts * align`` — consumers must tolerate zero-row
    partitions.
    """
    n_parts = max(1, int(n_parts))
    align = max(1, int(align))
    per = -(-n_rows // n_parts)           # ceil split ...
    per = -(-per // align) * align        # ... rounded up to the alignment
    bounds = np.minimum(np.arange(n_parts + 1, dtype=np.int64) * per, n_rows)
    return bounds


class PartitionedStore:
    """One host's row-range view of a shared store (multi-host Alg. 2).

    Speaks the full row-store protocol, but ``iter_chunks`` walks ONLY
    the rows of this partition — every sequential construction pass over
    a ``PartitionedStore`` touches ~``n_rows / n_parts`` rows, which is
    what bounds each host's share of the multi-host streaming build.
    Chunk windows stay aligned to the GLOBAL ``[k*rows, (k+1)*rows)``
    grid (clipped to the partition), so the union of all hosts' windows
    is exactly the single-process window sequence.

    Random access (``read_rows`` / ``read_slice``) deliberately passes
    through to the parent store — the paper's setting is a shared
    parallel filesystem, and construction needs a few tiny global
    gathers (k-means seeding). ``remote_rows_read`` counts rows served
    from outside the partition so tests can pin that the steady-state
    pipeline never leans on it.
    """

    def __init__(self, store, n_parts: int, part: int, align: int | None = None):
        if not 0 <= int(part) < int(n_parts):
            raise ValueError(f"part {part} outside [0, {n_parts})")
        self.parent = store
        self.n_parts = int(n_parts)
        self.part = int(part)
        if align is None:
            align = getattr(store, "shard_rows", 1)
            # Shard alignment only helps while it doesn't starve parts.
            if align > 1 and store.n_rows < self.n_parts * align:
                align = 1
        self._bounds = partition_bounds(store.n_rows, self.n_parts, align)
        self.start = int(self._bounds[self.part])
        self.stop = int(self._bounds[self.part + 1])
        self.remote_rows_read = 0  # telemetry: rows gathered outside the part

    # -- metadata (global, protocol-compatible) ------------------------

    @property
    def n_rows(self) -> int:
        return self.parent.n_rows

    @property
    def d(self) -> int:
        return self.parent.d

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def n_local(self) -> int:
        return self.stop - self.start

    # -- reads ---------------------------------------------------------

    def read_slice(self, start: int, stop: int):
        self.remote_rows_read += max(
            0, min(stop, self.parent.n_rows) - max(start, 0)
        ) - max(0, min(stop, self.stop) - max(start, self.start))
        return self.parent.read_slice(start, stop)

    def read_rows(self, idx: np.ndarray):
        idx = np.asarray(idx, dtype=np.int64)
        self.remote_rows_read += int(np.sum((idx < self.start) | (idx >= self.stop)))
        return self.parent.read_rows(idx)

    def iter_chunks(self, rows: int | None = None):
        """Global-grid chunk windows clipped to this partition."""
        n = self.parent.n_rows
        rows = n if rows is None else max(1, int(rows))
        first = (self.start // rows) * rows
        for gstart in range(first, self.stop, rows):
            a, b = max(gstart, self.start), min(gstart + rows, self.stop)
            if a >= b:
                continue
            x, y = self.parent.read_slice(a, b)
            yield a, x, y
