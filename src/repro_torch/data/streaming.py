"""Streaming (out-of-core) SBV construction over a row store, and the spool.

Counterpart of the single-process half of ``repro.data.streaming``. Every
stage of the in-core preprocessing pipeline (scale -> block -> order ->
NNS -> pack) assumes the full ``(n, d)`` dataset sits in host RAM. This
module rebuilds each stage as a pass over ``store.iter_chunks(rows)``
windows, so the resident working set is bounded by the chunk size, not
``n``:

* ``streaming_kmeans_blocks`` — mini-batch k-means over chunk iterators
  (Sculley-style center updates with per-epoch count resets, so the
  single-chunk case reduces EXACTLY to Lloyd iterations), then one
  labeling pass that also accumulates exact centroids, per-dimension
  extents (for the Eq. 7 NNS radius) and a radius pass against the final
  centers;
* ``LazyFlatBlocks`` — the store-backed twin of ``core.nns._FlatBlocks``:
  the same index bookkeeping, with member coordinates gathered on demand
  (LRU-cached per block). Block ids are relabeled in center-coordinate
  order, so the NNS sweep visits spatially adjacent blocks consecutively;
* ``plan_block_chunks`` / ``pack_block_chunk`` — conditioning-rank-ordered
  groups of blocks whose member+neighbor rows fit the ``stream_chunk``
  budget, packed with ``pack_blocks`` on a gathered-and-remapped row
  subset;
* ``PackedChunkSpool`` — where the packed pieces wait between optimizer
  steps: on the device (one copy per round), or in ``.npz`` files that a
  producer thread reads into pinned host memory and copies to the card on
  a side stream while the card computes on the previous piece.

The host half is numpy and bitwise the reference's: the same store gives
the same blocks, neighbour lists, plans and packed pieces. A
``MemoryStore`` and an ``ArrayStore`` holding the same rows give identical
structures, packings and fits; the spool's tiers change nothing bitwise.
The multi-host half of the reference (``multihost_preprocess`` and its
helpers) is not ported yet.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.blocks import BlockStructure, _maxmin_order, most_relevant_dim, scale_inputs
from repro_torch.core.nns import _FlatBlocks, filtered_nns
from repro_torch.core.packing import PackedBlocks, pack_blocks
from repro_torch.core.vecchia import MAP_BATCH
from repro_torch.kernels.ops import BACKWARD_CHUNK
from repro_torch.prefetch import Prefetcher

DEFAULT_STRUCT_BATCH = 65536  # rows per structure pass (decoupled from
                              # stream_chunk so the packing window can vary
                              # without changing the k-means trajectory)
ROW_TILE = 2048               # rows per assignment distance tile
MAX_D2_ENTRIES = 2 << 20      # bound on distance-tile size (entries)


# -- chunked moments -------------------------------------------------------


def streaming_moments(store, batch_rows: int = DEFAULT_STRUCT_BATCH):
    """(mean, variance) of y accumulated chunk-wise (population variance,
    matching ``np.var`` up to summation order).

    Two shifted passes: pass 1 accumulates the mean, pass 2 accumulates
    ``sum((y - mean)^2)``. The one-pass ``E[y^2] - mean^2`` form cancels
    catastrophically when ``|mean| >> std`` (a y offset of 1e8 collapses
    the variance to the clamp at 0, silently initializing ``sigma2 ~ 0``
    for the streaming fit); the shifted form keeps full precision there
    while still visiting identical windows on either store backend, so
    MemoryStore/ArrayStore parity stays bitwise.
    """
    n = store.n_rows
    s = 0.0
    for _, _, yw in store.iter_chunks(batch_rows):
        s += float(np.sum(yw))
    mean = s / max(n, 1)
    ss = 0.0
    for _, _, yw in store.iter_chunks(batch_rows):
        r = yw - mean
        ss += float(np.sum(r * r))
    return mean, ss / max(n, 1)


# -- mini-batch k-means blocking ------------------------------------------


def _center_tile(n_centers: int) -> int:
    """Centers per distance tile: keeps row_tile x center_tile bounded."""
    return max(32, min(2048, MAX_D2_ENTRIES // ROW_TILE))


def _assign_chunk(xs: np.ndarray, centers: np.ndarray, c2: np.ndarray):
    """Nearest-center label per row, tiled over rows AND centers so the
    distance buffer never exceeds ROW_TILE x center-tile entries.

    The assignment is memory-bound (n x k distance entries dwarf the
    rank-d GEMM), so the tiles run in float32 with the row-norm term
    dropped — ``argmin_j ||x - c_j||^2 = argmin_j (c2_j - 2 x.c_j)`` —
    and in-place updates: ~3x less traffic than the naive f64 broadcast.
    Labels are a clustering heuristic (everything downstream that needs
    exactness — radii, centroids, NNS — recomputes in f64), and both
    store backends run the identical instruction stream, so bitwise
    memory/disk parity is preserved. Strict-< running best keeps
    numpy's first-minimum tie-breaking across center tiles."""
    n, k = xs.shape[0], centers.shape[0]
    ct = _center_tile(k)
    cen32 = np.ascontiguousarray(centers.T, dtype=np.float32)  # (d, k)
    c232 = c2.astype(np.float32)
    labels = np.empty(n, dtype=np.int64)
    for rs in range(0, n, ROW_TILE):
        xr = xs[rs:rs + ROW_TILE].astype(np.float32)
        rows = np.arange(xr.shape[0])
        best = np.full(xr.shape[0], np.inf, dtype=np.float32)
        lab = np.zeros(xr.shape[0], dtype=np.int64)
        for cs in range(0, k, ct):
            d2 = xr @ cen32[:, cs:cs + ct]
            d2 *= -2.0
            d2 += c232[cs:cs + ct][None, :]
            j = np.argmin(d2, axis=1)
            v = d2[rows, j]
            upd = v < best
            best[upd] = v[upd]
            lab[upd] = j[upd] + cs
        labels[rs:rs + ROW_TILE] = lab
    return labels


def _label_sums(labels: np.ndarray, xs: np.ndarray, k: int):
    """Per-label row counts and coordinate sums (bincount per dim: C-fast)."""
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.stack(
        [np.bincount(labels, weights=xs[:, j], minlength=k)
         for j in range(xs.shape[1])], axis=1,
    )
    return counts, sums


def streaming_kmeans_blocks(
    store,
    beta: np.ndarray,
    n_blocks: int,
    n_workers: int = 1,
    seed: int = 0,
    epochs: int = 2,
    batch_rows: int = DEFAULT_STRUCT_BATCH,
    ordering: str = "random",
):
    """Mini-batch k-means blocking over chunk iterators.

    Returns ``(BlockStructure, radii, domain_volume)`` — everything the
    filtered NNS needs, with nothing larger than index arrays held in
    RAM. Deterministic given (store contents, seed, batch_rows); with
    ``batch_rows >= n`` every epoch is exactly one Lloyd iteration.

    Block ids are assigned in center-coordinate order along the most
    relevant dimension, so id-ordered sweeps (the NNS loop) visit
    spatially adjacent blocks consecutively — that locality is what makes
    the store-backed lazy gather cache effective.
    """
    rng = np.random.default_rng(seed)
    n, d = store.n_rows, store.d
    beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (d,))
    k = min(int(n_blocks), n)

    init_idx = rng.choice(n, size=k, replace=False)
    centers = scale_inputs(store.read_rows(init_idx)[0], beta)

    for _ in range(max(int(epochs), 0)):
        counts = np.zeros(k)
        c2 = np.sum(centers * centers, axis=1)
        for _, xw, _ in store.iter_chunks(batch_rows):
            xs = scale_inputs(xw, beta)
            lab = _assign_chunk(xs, centers, c2)
            k_c, sums = _label_sums(lab, xs, k)
            counts += k_c
            nz = k_c > 0
            centers[nz] += (sums[nz] - k_c[nz, None] * centers[nz]) / counts[nz, None]
            c2 = np.sum(centers * centers, axis=1)
        empty = counts == 0
        if empty.any():
            re_idx = rng.choice(n, size=int(empty.sum()), replace=False)
            centers[empty] = scale_inputs(store.read_rows(re_idx)[0], beta)

    # Final labeling pass: exact centroids + scaled-domain extents.
    labels = np.empty(n, dtype=np.int64)
    counts = np.zeros(k)
    sums = np.zeros((k, d))
    mins = np.full(d, np.inf)
    maxs = np.full(d, -np.inf)
    c2 = np.sum(centers * centers, axis=1)
    for start, xw, _ in store.iter_chunks(batch_rows):
        xs = scale_inputs(xw, beta)
        lab = _assign_chunk(xs, centers, c2)
        labels[start:start + xs.shape[0]] = lab
        k_c, s_c = _label_sums(lab, xs, k)
        counts += k_c
        sums += s_c
        np.minimum(mins, xs.min(axis=0), out=mins)
        np.maximum(maxs, xs.max(axis=0), out=maxs)

    # Compact away empty blocks, then relabel in center-coordinate order.
    occupied = np.nonzero(counts > 0)[0]
    centers = sums[occupied] / counts[occupied][:, None]
    dprime = most_relevant_dim(beta)
    coord_order = np.argsort(centers[:, dprime], kind="stable")
    centers = centers[coord_order]
    bc = occupied.size
    old_to_new = np.full(k, -1, dtype=np.int64)
    old_to_new[occupied[coord_order]] = np.arange(bc)
    labels = old_to_new[labels]

    # Radius pass against the FINAL centers (upper bound the coarse
    # filter relies on; running centers would under-estimate it).
    r2 = np.zeros(bc)
    for start, xw, _ in store.iter_chunks(batch_rows):
        xs = scale_inputs(xw, beta)
        lab = labels[start:start + xs.shape[0]]
        d2 = np.sum((xs - centers[lab]) ** 2, axis=1)
        np.maximum.at(r2, lab, d2)
    radii = np.sqrt(r2)

    # Members from one stable argsort (ascending indices within a block,
    # matching np.nonzero order in the in-core block construction).
    by_block = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=bc)
    members = np.split(by_block, np.cumsum(sizes)[:-1])

    # Owner shard per block by quantile bucketing of the center coordinate
    # (same locality property as the per-point Alg. 2 partition).
    if n_workers > 1:
        qs = np.quantile(centers[:, dprime],
                         np.linspace(0.0, 1.0, n_workers + 1)[1:-1])
        owners = np.searchsorted(qs, centers[:, dprime], side="right")
    else:
        owners = np.zeros(bc, dtype=np.int64)

    if ordering == "random":
        order = rng.permutation(bc)
    elif ordering == "coord":
        order = np.arange(bc)  # ids are already in coordinate order
    elif ordering == "maxmin":
        order = _maxmin_order(centers, rng)  # centers are in-RAM: bc x d
    else:
        raise ValueError(f"unknown streaming ordering {ordering!r}")
    rank_of_block = np.empty(bc, dtype=np.int64)
    rank_of_block[order] = np.arange(bc)

    ext = maxs - mins
    med = np.median(ext[ext > 0]) if np.any(ext > 0) else 1.0
    ext = np.maximum(ext, 1e-6 * med)
    domain_volume = float(np.prod(ext))

    blocks = BlockStructure(
        labels=labels,
        order=np.asarray(order, dtype=np.int64),
        rank_of_block=rank_of_block,
        centers=centers,
        owners=np.asarray(owners, dtype=np.int32),
        members=members,
    )
    return blocks, radii, domain_volume


# -- store-backed flat block index ----------------------------------------


class LazyFlatBlocks(_FlatBlocks):
    """``_FlatBlocks`` over a store: coordinates gathered on demand.

    Holds the same index bookkeeping (sizes/starts/flat_idx/flat_rank/
    radii) but no ``flat_pts``; ``points_of_blocks`` serves scaled member
    coordinates from a bytes-bounded per-block LRU cache, batching all
    cache misses of a call into one ``read_rows`` gather.
    """

    def __init__(self, blocks: BlockStructure, radii: np.ndarray, store,
                 beta: np.ndarray, cache_bytes: int = 32 << 20):
        sizes = np.asarray([mb.size for mb in blocks.members], dtype=np.int64)
        self.sizes = sizes
        self.starts = np.concatenate([[0], np.cumsum(sizes)])
        self.flat_idx = (
            np.concatenate(blocks.members) if blocks.n_blocks else np.empty(0, np.int64)
        )
        self.flat_rank = np.repeat(blocks.rank_of_block, sizes)
        self.radii = np.asarray(radii)
        self.n_rows = store.n_rows
        self.d = store.d
        self._store = store
        self._beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (store.d,))
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_bytes = 0
        self._cache_cap = int(cache_bytes)
        self.gathered_rows = 0  # telemetry: store rows actually read

    def _evict(self) -> None:
        while self._cache_bytes > self._cache_cap and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= old.nbytes

    def points_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        block_ids = np.asarray(block_ids, dtype=np.int64)
        if block_ids.size == 0:
            return np.empty((0, self.d))
        # Dedupe the miss list (preserving first-occurrence order): a
        # duplicate id in one call must be gathered and accounted ONCE —
        # double-counting ``_cache_bytes`` for a single retained copy
        # inflates the counter permanently and drives the LRU into
        # premature eviction.
        missing = list(dict.fromkeys(
            int(b) for b in block_ids if int(b) not in self._cache))
        if missing:
            rows = np.concatenate(
                [self.flat_idx[self.starts[b]:self.starts[b + 1]] for b in missing]
            )
            pts = scale_inputs(self._store.read_rows(rows)[0], self._beta)
            self.gathered_rows += rows.size
            off = 0
            for b in missing:
                k = int(self.sizes[b])
                self._cache[b] = pts[off:off + k]
                self._cache_bytes += self._cache[b].nbytes
                off += k
            self._evict()
        out = []
        for b in block_ids:
            b = int(b)
            pts = self._cache[b]
            self._cache.move_to_end(b)
            out.append(pts)
        return out[0] if len(out) == 1 else np.concatenate(out)


def streaming_filtered_nns(
    store, blocks: BlockStructure, radii: np.ndarray, beta: np.ndarray,
    m: int, alpha: float = 100.0, domain_volume: float | None = None,
    cache_bytes: int = 32 << 20,
):
    """Filtered preceding-block NNS with store-backed candidate gathers.

    The query sweep runs in block-id order == center-coordinate order
    (see ``streaming_kmeans_blocks``), so consecutive queries share most
    of their candidate blocks and the LRU cache bounds re-reads.
    Returns ``(neighbors, flat)`` so callers can keep the warm index.
    """
    flat = LazyFlatBlocks(blocks, radii, store, beta, cache_bytes=cache_bytes)
    bc = max(blocks.n_blocks, 1)
    center_chunk = max(16, min(2048, MAX_D2_ENTRIES // bc))
    neigh = filtered_nns(None, blocks, m, alpha=alpha, center_chunk=center_chunk,
                         flat=flat, domain_volume=domain_volume)
    return neigh, flat


# -- chunked packing -------------------------------------------------------


def plan_block_chunks(blocks: BlockStructure, neigh: list, m: int,
                      stream_chunk: int, ranks=None) -> list[np.ndarray]:
    """Group conditioning ranks so each group's member+neighbor rows fit
    the ``stream_chunk`` budget. Groups are contiguous in rank order;
    a single oversized block still gets its own chunk (the budget is a
    target, not a validity condition). ``ranks`` restricts the plan to a
    subsequence of conditioning ranks (a host's owned blocks in the
    multi-host build); the default plans every rank."""
    plans: list[np.ndarray] = []
    cur: list[int] = []
    rows = 0
    rank_seq = range(len(blocks.order)) if ranks is None else ranks
    for rank in rank_seq:
        rank = int(rank)
        b = blocks.order[rank]
        cost = int(blocks.members[b].size) + min(len(neigh[b]), m)
        if cur and rows + cost > stream_chunk:
            plans.append(np.asarray(cur, dtype=np.int64))
            cur, rows = [], 0
        cur.append(rank)
        rows += cost
    if cur:
        plans.append(np.asarray(cur, dtype=np.int64))
    return plans


def pack_block_chunk(
    store, blocks: BlockStructure, neigh: list, ranks: np.ndarray,
    m: int, bs_max: int, dtype=np.float64,
) -> PackedBlocks:
    """Pack one rank-chunk by gathering the union of its member+neighbor
    rows once and remapping indices into the gathered subset — the packed
    arrays are bit-identical to the same blocks' slices of an in-core
    ``pack_blocks`` (gathers preserve values and relative order)."""
    bids = blocks.order[ranks]
    pieces = [blocks.members[b] for b in bids] + [neigh[b][:m] for b in bids]
    rows_needed = np.unique(np.concatenate(pieces)) if pieces else np.empty(0, np.int64)
    xg, yg = store.read_rows(rows_needed)

    def remap(a):
        return np.searchsorted(rows_needed, a)

    kb = len(bids)
    mini = BlockStructure(
        labels=np.empty(0, dtype=np.int64),
        order=np.arange(kb, dtype=np.int64),
        rank_of_block=np.arange(kb, dtype=np.int64),
        centers=np.zeros((kb, store.d)),
        owners=np.asarray([blocks.owners[b] for b in bids], dtype=np.int32),
        members=[remap(blocks.members[b]) for b in bids],
    )
    neigh_local = [remap(neigh[b][:m]) for b in bids]
    return pack_blocks(xg, yg, mini, neigh_local, m, bs_max=bs_max, dtype=dtype)


_SPOOL_KEYS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask")


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _npz_encode(items: dict) -> dict:
    """npz-safe view of a named-array bundle.

    ``np.savez`` has no bfloat16, so bf16 arrays (the precision ladder's
    narrow coordinate tier, ``torch.bfloat16`` tensors in this package) are
    spooled as their uint16 bit pattern under a ``__bf16__<name>`` flag key,
    the reference's convention, and re-viewed on load. Other tensors are
    stored as numpy arrays. Bit-exact round trip."""
    out = {}
    for k, a in items.items():
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            if a.dtype == torch.bfloat16:
                out[f"__bf16__{k}"] = a.view(torch.int16).numpy().view(np.uint16)
                continue
            a = a.numpy()
        out[k] = a
    return out


def _npz_read(z, k: str) -> torch.Tensor:
    """One array of an npz written via ``_npz_encode``, as a host tensor."""
    if k in z:
        return torch.from_numpy(z[k])
    return torch.from_numpy(z[f"__bf16__{k}"].view(np.int16)).view(torch.bfloat16)


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_array(a):
    """numpy on the host; a bf16 tensor stays a tensor (numpy has no bf16)."""
    if isinstance(a, torch.Tensor):
        return a if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
    return np.asarray(a)


def _host_available_bytes() -> int | None:
    """MemAvailable from /proc/meminfo (the CPU device's 'free memory')."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def device_cache_budget(frac: float = 0.5, reserve_bytes: int = 0, device=None) -> int:
    """Byte budget for the device-resident spool tier.

    ``frac`` of the device's free memory (``torch.cuda.mem_get_info`` on a
    CUDA device) minus ``reserve_bytes``, the headroom the caller needs for
    compute (the streaming fit passes ``stream_reserve_bytes``, so the
    cache can never squeeze out the backward pass's live set). On the CPU
    device, device memory IS host RAM, so MemAvailable stands in; when it
    cannot be read, 4 GB is assumed."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = _host_available_bytes() or (4 << 30)
    return max(0, int(frac * free) - int(reserve_bytes))


# The plain backward's live set (kernels/ops.py: _chunked_vjp on the kernel
# route, the checkpointed slices of the `ref` route), counted by tallying
# every tensor alive while one chunk runs forward and backward
# (tests/test_torch_streaming.py holds this count above the tally):
# - per block, at most 12.5 (bs + m)^2 elements: autograd's saved tensors
#   and the backward's temporaries (the Cholesky and triangular-solve
#   gradients) of the joint form, twelve square buffers and a bool mask;
#   the single-output chain form needs 7.2 at bs = m and up to 12.1 when
#   one of bs, m dominates;
# - per block, under 6 columns of (bs + m) for every output and every
#   coordinate: the solves' right-hand sides and their gradients, the
#   scaled coordinates;
# - per chunk, one (bs + m)^2 identity.
BACKWARD_SQUARES = 12.5
BACKWARD_COLUMNS = 6


def backward_live_bytes(bs_max: int, m: int, blocks: int, itemsize: int = 8,
                        n_out: int = 1, d: int = 0) -> int:
    """Bytes the backward of ``blocks`` padded blocks keeps alive at once,
    for ``n_out`` outputs and ``d`` coordinates."""
    k = bs_max + m
    per_block = BACKWARD_SQUARES * k * k + BACKWARD_COLUMNS * k * (n_out + d)
    return int(itemsize * (blocks * per_block + k * k))


def stream_reserve_bytes(bs_max: int, m: int, bc_pad: int, piece_bytes: int,
                         backend: str, prefetch: int, acc_itemsize: int = 8,
                         n_out: int = 1, d: int = 0) -> int:
    """Device memory the streaming fit needs beside the spool's device tier.

    * the backward's live set (``backward_live_bytes``): the kernel route
      recomputes the plain version in chunks of ``ops.BACKWARD_CHUNK``
      blocks at the f64 promotion of the master parameters; the ``ref``
      route in checkpointed slices of ``MAP_BATCH`` blocks at the pieces'
      own accumulation width;
    * the kernel's scratch, (bs + m + 1)(bs + m) per CTA, at most one CTA
      per block of a piece;
    * the staged pieces in flight: one being computed, ``prefetch`` queued
      and one in the producer's hands."""
    if backend == "ref":
        grad = backward_live_bytes(bs_max, m, min(bc_pad, MAP_BATCH), acc_itemsize, n_out, d)
        scratch = 0
    else:
        grad = backward_live_bytes(bs_max, m, min(bc_pad, BACKWARD_CHUNK), 8, n_out, d)
        scratch = bc_pad * (bs_max + m + 1) * (bs_max + m) * acc_itemsize
    return grad + scratch + (int(prefetch) + 2) * int(piece_bytes)


class PackedChunkSpool:
    """Two-tier cache of packed chunk pieces for one structure round.

    The likelihood inner loop re-reads every piece once per optimizer
    step, so WHERE the pieces wait between steps is the streaming fit's
    hot-path bandwidth question:

    * **device tier** — pieces added while cumulative bytes fit
      ``device_budget`` are copied to ``device`` ONCE
      (``torch.from_numpy(a).to(device)``) and stay resident across every
      inner step of the round;
    * **disk tier** — overflow pieces spool to uncompressed ``.npz`` (the
      reference's layout; float64 round-trips bit-exactly) and are
      re-staged every step. On a CUDA device a stage reads the piece into
      pinned host memory and copies it with ``non_blocking=True`` on the
      spool's own stream, then records an event; the consumer's stream
      waits on that event before computing, and the staged tensors are
      ``record_stream``-ed on it so the allocator cannot hand their memory
      to the next copy while a kernel still reads it. ``iter_arrays`` runs
      the stages on a ``Prefetcher`` thread ahead of the consumer.

    Iteration order is ALWAYS add order regardless of tier, so the grad
    accumulation order — and therefore the fit, bitwise — is identical
    whether a piece sat on the card, behind the prefetcher, or on cold
    disk.
    """

    def __init__(self, path: str, device_budget: int = 0, device="cpu",
                 device_stage: bool = True):
        self.path = path
        self.device_budget = int(device_budget)
        self.device = torch.device(device)
        # device_stage=False keeps staged arrays as host numpy: a sink whose
        # outputs are consumed on the host needs no device round trip.
        self.device_stage = device_stage
        self._stream = (torch.cuda.Stream(device=self.device)
                        if device_stage and self.device.type == "cuda" else None)
        # entries: (kind, payload, tag, nbytes, keys); payload is a tuple
        # (or, for ``add_arrays`` bundles, a dict) of device tensors
        # ("dev") or an .npz path ("disk"); ``tag`` is an opaque caller
        # label (the fit stores the resolved backend); ``keys`` is None for
        # the positional packed-piece layout (_SPOOL_KEYS) or the bundle's
        # own names.
        self._entries: list[tuple] = []
        self._made_dir = False
        self.packed_bytes_max = 0
        self.packed_bytes_total = 0
        self.device_bytes = 0
        self.disk_bytes_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_device(self) -> int:
        return sum(1 for e in self._entries if e[0] == "dev")

    @property
    def n_disk(self) -> int:
        return len(self) - self.n_device

    def _put_device(self, a):
        if not self.device_stage:
            return _host_array(a)
        return _host_tensor(a).to(self.device)

    def _spill(self, items: dict, keys, tag, nbytes: int, **extra) -> None:
        if not self._made_dir:
            os.makedirs(self.path, exist_ok=True)
            self._made_dir = True
        f = os.path.join(self.path, f"chunk_{len(self._entries):05d}.npz")
        np.savez(f, **extra, **_npz_encode(items))
        self._entries.append(("disk", f, tag, nbytes, keys))
        self.disk_bytes_total += nbytes

    def add(self, packed: PackedBlocks, tag=None) -> None:
        arrs = tuple(getattr(packed, k) for k in _SPOOL_KEYS)
        nbytes = sum(_nbytes(a) for a in arrs)
        self.packed_bytes_max = max(self.packed_bytes_max, nbytes)
        self.packed_bytes_total += nbytes
        if self.device_bytes + nbytes <= self.device_budget:
            dev = tuple(self._put_device(a) for a in arrs)
            self._entries.append(("dev", dev, tag, nbytes, None))
            self.device_bytes += nbytes
            return
        self._spill(dict(zip(_SPOOL_KEYS, arrs)), None, tag, nbytes, owners=packed.owners)

    def add_arrays(self, arrays: dict, tag=None) -> None:
        """Spool one named-array bundle (numpy arrays or tensors) under the
        same two-tier / add-order contract as ``add``; ``iter_arrays``
        stages it back as a dict."""
        items = {k: (v if isinstance(v, torch.Tensor) else np.asarray(v))
                 for k, v in arrays.items()}
        nbytes = sum(_nbytes(a) for a in items.values())
        keys = tuple(items)
        self.packed_bytes_max = max(self.packed_bytes_max, nbytes)
        self.packed_bytes_total += nbytes
        if self.device_bytes + nbytes <= self.device_budget:
            dev = {k: self._put_device(a) for k, a in items.items()}
            self._entries.append(("dev", dev, tag, nbytes, keys))
            self.device_bytes += nbytes
            return
        self._spill(items, keys, tag, nbytes)

    def _stage(self, entry):
        """``(arrays, tag, pending)`` for one entry — the H2D hot path, run
        on the Prefetcher's producer thread. ``pending`` is the copy's
        ``(event, pinned host tensors)`` on a CUDA device, else None."""
        kind, payload, tag, _nb, keys = entry
        if kind == "dev":
            return payload, tag, None
        names = _SPOOL_KEYS if keys is None else keys
        with np.load(payload) as z:
            host = [_npz_read(z, k) for k in names]
        pending = None
        if not self.device_stage:
            out = [_host_array(t) for t in host]
        elif self._stream is None:
            out = [t.to(self.device) for t in host]
        else:
            # The producer thread has its own current device and stream.
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                pinned = [t.pin_memory() for t in host]
                out = [t.to(self.device, non_blocking=True) for t in pinned]
                event = torch.cuda.Event()
                event.record(self._stream)
            pending = (event, pinned)
        arrays = tuple(out) if keys is None else dict(zip(keys, out))
        return arrays, tag, pending

    def _ready(self, staged):
        """On the consumer's thread: order its stream after the copy and
        tie the staged tensors' memory to that stream."""
        arrays, tag, pending = staged
        if pending is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pending[0])
            for t in (arrays.values() if isinstance(arrays, dict) else arrays):
                t.record_stream(stream)
        return arrays, tag

    def iter_arrays(self, prefetch: int = 2):
        """Yield ``(arrays, tag)`` per piece, in add order.

        With ``prefetch > 0`` and disk-tier pieces present, staging runs on
        a producer thread ``prefetch`` items ahead (2 = double buffer):
        the host reads and copies piece k+1 while the device computes on
        piece k. ``prefetch=0`` is the synchronous loop — bitwise identical
        output, serial staging."""
        if prefetch > 0 and self.n_disk:
            with Prefetcher(iter(self._entries), depth=prefetch, stage=self._stage,
                            name="sbv-h2d") as staged:
                for item in staged:
                    yield self._ready(item)
        else:
            for entry in self._entries:
                yield self._ready(self._stage(entry))

    def cleanup(self) -> None:
        for kind, payload, *_ in self._entries:
            if kind == "disk":
                try:
                    os.remove(payload)
                except OSError:
                    pass
        self._entries = []  # drops the device-tier references too
        try:
            os.rmdir(self.path)
        except OSError:
            pass
        # Reset the per-round state so the spool object is reusable (the
        # directory is gone, so a later overflow-to-disk ``add`` recreates
        # it); ``packed_bytes_max/total`` stay cumulative high-water marks.
        self._made_dir = False
        self.device_bytes = 0
        self.disk_bytes_total = 0


@dataclass
class StreamStructure:
    """One outer round's streaming preprocessing product."""

    blocks: BlockStructure
    neigh: list
    flat: LazyFlatBlocks
    domain_volume: float
    plan: list
    bs_max: int


def streaming_preprocess(
    store, beta: np.ndarray, cfg, stream_chunk: int,
    struct_batch: int | None = None, cache_bytes: int = 32 << 20,
) -> StreamStructure:
    """scale -> mini-batch k-means -> order -> store-backed NNS -> plan.

    The streaming counterpart of ``core.pipeline.preprocess``; clustering
    is mini-batch k-means (the one pass-structured algorithm) regardless
    of ``cfg.clustering``, and the structure batch size is decoupled from
    ``stream_chunk`` so the packing window can change without changing
    the block structure."""
    blocks, radii, vol = streaming_kmeans_blocks(
        store, beta, cfg.n_blocks, n_workers=cfg.n_workers, seed=cfg.seed,
        batch_rows=struct_batch or DEFAULT_STRUCT_BATCH,
        ordering=cfg.ordering,
    )
    neigh, flat = streaming_filtered_nns(
        store, blocks, radii, beta, cfg.m, alpha=cfg.alpha,
        domain_volume=vol, cache_bytes=cache_bytes,
    )
    plan = plan_block_chunks(blocks, neigh, cfg.m, stream_chunk)
    bs_max = int(max(mb.size for mb in blocks.members))
    if cfg.bs_max is not None:
        bs_max = max(bs_max, cfg.bs_max)
    return StreamStructure(blocks=blocks, neigh=neigh, flat=flat,
                           domain_volume=vol, plan=plan, bs_max=bs_max)


# -- prediction-side gather ------------------------------------------------


def working_set_model(stream_stats: dict, n_rows: int, d: int, m: int,
                      stream_chunk: int, n_caches: int = 2, device="cpu") -> dict:
    """Bytes model of the streaming fit's resident working set.

    The reference's model (``repro.data.streaming.working_set_model``) with
    the port's own backward in the device-grad term; the host terms are the
    reference's. One definition for the RSS gates, which assert
    ``peak_rss_delta <= 2 x total``. Terms:

    * chunk windows — raw rows + scaled copy + one transient (3x);
    * packed chunk  — host .npz load + device transfer + arena slack (4x);
    * device grad   — the backward's live set (``backward_live_bytes``):
      ``stream_stats['backward_blocks']`` blocks at a time (the kernel
      route's ``ops.BACKWARD_CHUNK``, the ``ref`` route's ``MAP_BATCH``)
      at ``stream_stats['backward_itemsize']`` bytes, for
      ``stream_stats['n_outputs']`` outputs (1 when absent), independent
      of chunk size;
    * NNS scan      — worst-case candidate gather: with a near-isotropic
      beta in higher d the coarse filter can admit most blocks for one
      query, so the transient is O(n x d) (concat + squared distances);
    * index arrays  — labels/members/flat_idx/flat_rank + neighbor lists;
    * gather caches — the LRU block-point caches (fit and predict index);
    * device spool  — the device-resident spool tier: on the CPU device
      the cached pieces ARE host RSS, so they count double (buffer +
      transfer transient). Only present when the run cached pieces.

    On a CUDA ``device`` the device-grad and device-spool terms live in
    device memory: they are returned under ``device_terms`` and left out
    of ``terms`` and ``total``, which then model host RSS alone.

    The same constants applied to the WHOLE dataset give
    ``incore_total``: what the monolithic path would hold resident. The
    multi-host terms of the reference wait for the multi-host fit.
    """
    st = stream_stats
    joint2 = (st["bs_max"] + m) ** 2
    terms = {
        "chunk_windows": 3 * stream_chunk * (d + 1) * 8,
        "packed_chunk": 4 * st["packed_chunk_bytes_max"],
        "device_grad": backward_live_bytes(st["bs_max"], m, st["backward_blocks"],
                                           st["backward_itemsize"], st.get("n_outputs", 1), d),
        "nns_scan": 3 * n_rows * d * 8,
        "index_arrays": 4 * n_rows * 8 + st["bc"] * m * 8,
        "gather_caches": n_caches * (32 << 20),
    }
    if st.get("device_cached_bytes"):
        terms["device_spool"] = 2 * st["device_cached_bytes"]
    device_terms = {}
    if torch.device(device).type == "cuda":
        device_terms = {k: terms.pop(k) for k in ("device_grad", "device_spool") if k in terms}
    total = sum(terms.values())
    incore_total = (
        2 * n_rows * (d + 1) * 8      # raw + scaled arrays resident
        + 2 * st["spool_bytes"]        # packed dataset, host + device
        + 4 * st["bc"] * joint2 * 8    # vmapped grad live set over all blocks
    )
    return {"terms": terms, "device_terms": device_terms, "total": total,
            "incore_total": incore_total}


def localize_neighbors(store, neighbors: list):
    """Gather the union of neighbor rows once and remap each list into the
    gathered subset — hands ``pack_prediction`` small in-core arrays in
    place of the full training set. Values and per-list order are
    preserved, so the packed arrays are bit-identical to the in-core
    path's."""
    if neighbors:
        rows_needed = np.unique(np.concatenate([np.asarray(nb) for nb in neighbors]))
    else:
        rows_needed = np.empty(0, np.int64)
    xg, yg = store.read_rows(rows_needed)
    remapped = [np.searchsorted(rows_needed, np.asarray(nb)) for nb in neighbors]
    return xg, yg, remapped
