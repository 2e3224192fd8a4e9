"""Streaming (out-of-core) SBV construction over a row store, and the spool.

Counterpart of ``repro.data.streaming``. Every
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

The multi-host half (``multihost_preprocess`` and its helpers) runs the
same stages per rank process over a ``PartitionedStore``, communicating
through a ``repro_torch.multihost`` comm: a per-window k-means
all-reduce, the membership all-to-all into a ``HostRowTable`` and the
halo exchange of the filtered NNS (see the section's comment below).

The host half is numpy and bitwise the reference's: the same store gives
the same blocks, neighbour lists, plans and packed pieces, and the same
partitioned store and comm give the same per-rank structures. A
``MemoryStore`` and an ``ArrayStore`` holding the same rows give identical
structures, packings and fits; the spool's tiers change nothing bitwise.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.blocks import BlockStructure, _maxmin_order, most_relevant_dim, scale_inputs
from repro_torch.core.nns import _FlatBlocks, _one_block, filtered_nns, nns_radius
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


def streaming_moments(store, batch_rows: int = DEFAULT_STRUCT_BATCH, comm=None):
    """(mean, variance) of y accumulated chunk-wise (population variance,
    matching ``np.var`` up to summation order).

    Two shifted passes: pass 1 accumulates the mean, pass 2 accumulates
    ``sum((y - mean)^2)``. The one-pass ``E[y^2] - mean^2`` form cancels
    catastrophically when ``|mean| >> std`` (a y offset of 1e8 collapses
    the variance to the clamp at 0, silently initializing ``sigma2 ~ 0``
    for the streaming fit); the shifted form keeps full precision there
    while still visiting identical windows on either store backend, so
    MemoryStore/ArrayStore parity stays bitwise.

    ``comm`` (a ``repro_torch.multihost`` host comm) all-reduces the pass
    sums so each host only walks its own partition of the rows.
    """
    n = store.n_rows
    s = 0.0
    for _, _, yw in store.iter_chunks(batch_rows):
        s += float(np.sum(yw))
    if comm is not None:
        s = float(comm.allreduce(np.asarray([s]))[0])
    mean = s / max(n, 1)
    ss = 0.0
    for _, _, yw in store.iter_chunks(batch_rows):
        r = yw - mean
        ss += float(np.sum(r * r))
    if comm is not None:
        ss = float(comm.allreduce(np.asarray([ss]))[0])
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


# -- multi-host construction (Alg. 2 across processes) ---------------------
#
# The single-process streaming build above bounds RAM; this section bounds
# it PER HOST. Each rank process owns one `PartitionedStore`
# row range, and the stages communicate exactly like the paper's MPI
# pipeline:
#
#   k-means      — per-host labeling of local windows; per-window
#                  (count, sum) all-reduce, so every host applies the
#                  identical center update (the single-process trajectory
#                  when partition bounds align to the window grid);
#   membership   — each local row is sent once to the host owning its
#                  block (Alg. 2's MPI_Alltoall), giving the owner a
#                  `HostRowTable` of ~n/P rows: the only copy of the data
#                  it keeps resident;
#   filtered NNS — each host sweeps only its owned query blocks; foreign
#                  candidate blocks admitted by the coarse filter
#                  (dist <= lam + radius_j, replicated centers/radii) are
#                  pulled from their owners in lockstep halo-exchange
#                  rounds — `_one_block` runs UNCHANGED over a flat-blocks
#                  view that raises `_HaloMiss` for absent blocks, so the
#                  candidate-set semantics are identical to the
#                  single-process sweep;
#   packing      — `plan_block_chunks(ranks=owned)` + the unchanged
#                  `pack_block_chunk` against the row table, spooled to a
#                  per-host `PackedChunkSpool`.
#
# No stage materializes the full dataset or the full packed set on any
# process. With `LoopbackComm` (P=1) every all-reduce is the identity and
# the construction is bitwise the single-process one (held in
# tests/test_torch_multihost.py, as real gloo ranks are).


@dataclass
class MultihostStructure:
    """One host's share of a multi-process streaming preprocessing round."""

    blocks: BlockStructure     # global order/centers/host-owners; members
                               # filled for owned (+ fetched halo) blocks,
                               # None elsewhere; labels are LOCAL rows only
    neigh: list                # neighbor ids for owned blocks, [] elsewhere
    table: "HostRowTable"      # rows of owned blocks + fetched halo rows
    host_of_block: np.ndarray  # (bc,) owning host per block id
    sizes: np.ndarray          # (bc,) GLOBAL block sizes
    domain_volume: float
    plan: list                 # rank-chunks over owned ranks only
    bs_max: int                # GLOBAL max block size (shared piece shapes)
    stats: dict


class HostRowTable:
    """Sorted (global id -> row) table of the rows a host keeps resident.

    Built from the membership exchange (rows of owned blocks) and grown
    by halo fetches; `read_rows` serves any subset in requested order via
    one searchsorted, so `pack_block_chunk` runs against it unchanged.
    """

    def __init__(self, d: int):
        self._d = int(d)
        self.gid = np.empty(0, np.int64)
        self.x = np.empty((0, self._d))
        self.y = np.empty(0)

    @property
    def d(self) -> int:
        return self._d

    @property
    def n_rows(self) -> int:
        return int(self.gid.size)

    def add(self, ids: np.ndarray, x: np.ndarray, y: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        gid = np.concatenate([self.gid, ids])
        order = np.argsort(gid, kind="stable")
        self.gid = gid[order]
        self.x = np.concatenate([self.x, np.asarray(x, np.float64)])[order]
        self.y = np.concatenate([self.y, np.asarray(y, np.float64)])[order]

    def read_rows(self, idx: np.ndarray):
        idx = np.asarray(idx, np.int64)
        pos = np.searchsorted(self.gid, idx)
        if idx.size:
            bad = (pos >= self.gid.size) | (self.gid[np.minimum(pos, self.gid.size - 1)] != idx)
            if bad.any():
                raise KeyError(
                    f"{int(bad.sum())} rows absent from this host's table "
                    f"(first: {idx[bad][:5].tolist()})")
        return self.x[pos], self.y[pos]


def multihost_kmeans_blocks(
    pstore,
    beta: np.ndarray,
    n_blocks: int,
    comm,
    seed: int = 0,
    epochs: int = 2,
    batch_rows: int = DEFAULT_STRUCT_BATCH,
    ordering: str = "random",
):
    """`streaming_kmeans_blocks` with per-window (count, sum) all-reduce.

    Every host walks only its `PartitionedStore` windows but applies the
    same center update per GLOBAL window (hosts whose partition misses a
    window contribute zeros), so the center trajectory — and, with
    window-aligned partitions, its exact floats — matches the
    single-process mini-batch k-means. The rng stream (seeding, empty-
    block reseeds, the final permutation) is consumed identically on all
    hosts, so everything replicated stays replicated.

    Returns ``(blocks, labels_local, radii, domain_volume,
    host_of_block)`` where ``blocks.members`` is filled ONLY for blocks
    this host owns (ascending global ids, the single-process member
    order) and ``blocks.labels`` holds the host's LOCAL rows.
    """
    rng = np.random.default_rng(seed)
    n, d = pstore.n_rows, pstore.d
    beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (d,))
    k = min(int(n_blocks), n)
    batch_rows = max(1, int(batch_rows))
    n_windows = -(-n // batch_rows)

    init_idx = rng.choice(n, size=k, replace=False)
    centers = scale_inputs(pstore.read_rows(init_idx)[0], beta)

    def _local_windows(gstart, it, pending):
        """Local (xs, lab) pieces of the global window at ``gstart``."""
        pieces = []
        while pending[0] is not None and \
                gstart <= pending[0][0] < gstart + batch_rows:
            a, xw, _ = pending[0]
            xs = scale_inputs(xw, beta)
            pieces.append((a, xs))
            pending[0] = next(it, None)
        return pieces

    for _ in range(max(int(epochs), 0)):
        counts = np.zeros(k)
        c2 = np.sum(centers * centers, axis=1)
        it = pstore.iter_chunks(batch_rows)
        pending = [next(it, None)]
        for gstart in range(0, n, batch_rows):
            k_c = np.zeros(k)
            sums = np.zeros((k, d))
            for _, xs in _local_windows(gstart, it, pending):
                lab = _assign_chunk(xs, centers, c2)
                kc_w, s_w = _label_sums(lab, xs, k)
                k_c += kc_w
                sums += s_w
            red = comm.allreduce(np.concatenate([k_c[:, None], sums], axis=1))
            k_c, sums = red[:, 0], red[:, 1:]
            counts += k_c
            nz = k_c > 0
            centers[nz] += (sums[nz] - k_c[nz, None] * centers[nz]) / counts[nz, None]
            c2 = np.sum(centers * centers, axis=1)
        empty = counts == 0
        if empty.any():
            re_idx = rng.choice(n, size=int(empty.sum()), replace=False)
            centers[empty] = scale_inputs(pstore.read_rows(re_idx)[0], beta)

    # Final labeling pass: LOCAL labels; exact global centroids/extents
    # via one all-reduce of the per-host accumulators.
    n_local = pstore.n_local
    local_start = pstore.start
    labels_local = np.empty(n_local, dtype=np.int64)
    counts = np.zeros(k)
    sums = np.zeros((k, d))
    mins = np.full(d, np.inf)
    maxs = np.full(d, -np.inf)
    c2 = np.sum(centers * centers, axis=1)
    for a, xw, _ in pstore.iter_chunks(batch_rows):
        xs = scale_inputs(xw, beta)
        lab = _assign_chunk(xs, centers, c2)
        labels_local[a - local_start:a - local_start + xs.shape[0]] = lab
        k_c, s_c = _label_sums(lab, xs, k)
        counts += k_c
        sums += s_c
        np.minimum(mins, xs.min(axis=0), out=mins)
        np.maximum(maxs, xs.max(axis=0), out=maxs)
    counts = comm.allreduce(counts)
    sums = comm.allreduce(sums)
    mins = comm.allreduce(mins, op="min")
    maxs = comm.allreduce(maxs, op="max")

    occupied = np.nonzero(counts > 0)[0]
    centers = sums[occupied] / counts[occupied][:, None]
    sizes = counts[occupied]
    dprime = most_relevant_dim(beta)
    coord_order = np.argsort(centers[:, dprime], kind="stable")
    centers = centers[coord_order]
    sizes = np.rint(sizes[coord_order]).astype(np.int64)
    bc = occupied.size
    old_to_new = np.full(k, -1, dtype=np.int64)
    old_to_new[occupied[coord_order]] = np.arange(bc)
    labels_local = old_to_new[labels_local]

    # Radius pass against the final centers; max all-reduced per block.
    r2 = np.zeros(bc)
    for a, xw, _ in pstore.iter_chunks(batch_rows):
        xs = scale_inputs(xw, beta)
        lab = labels_local[a - local_start:a - local_start + xs.shape[0]]
        d2 = np.sum((xs - centers[lab]) ** 2, axis=1)
        np.maximum.at(r2, lab, d2)
    r2 = comm.allreduce(r2, op="max")
    radii = np.sqrt(r2)

    # Block -> owning HOST by quantile bucketing of the center coordinate
    # (the per-process analogue of the in-process worker owners).
    if comm.size > 1:
        qs = np.quantile(centers[:, dprime],
                         np.linspace(0.0, 1.0, comm.size + 1)[1:-1])
        host_of_block = np.searchsorted(qs, centers[:, dprime], side="right")
    else:
        host_of_block = np.zeros(bc, dtype=np.int64)
    host_of_block = host_of_block.astype(np.int64)

    if ordering == "random":
        order = rng.permutation(bc)
    elif ordering == "coord":
        order = np.arange(bc)
    elif ordering == "maxmin":
        order = _maxmin_order(centers, rng)
    else:
        raise ValueError(f"unknown streaming ordering {ordering!r}")
    rank_of_block = np.empty(bc, dtype=np.int64)
    rank_of_block[order] = np.arange(bc)

    ext = maxs - mins
    med = np.median(ext[ext > 0]) if np.any(ext > 0) else 1.0
    ext = np.maximum(ext, 1e-6 * med)
    domain_volume = float(np.prod(ext))

    blocks = BlockStructure(
        labels=labels_local,
        order=np.asarray(order, dtype=np.int64),
        rank_of_block=rank_of_block,
        centers=centers,
        owners=host_of_block.astype(np.int32),
        members=[None] * bc,
    )
    return blocks, radii, domain_volume, host_of_block, sizes


def _membership_exchange(pstore, blocks: BlockStructure, host_of_block,
                         comm) -> HostRowTable:
    """Route every local row to the host owning its block (Alg. 2
    alltoall) and fill ``blocks.members`` for this host's owned blocks.

    Rows travel with their global ids and labels; the receiver sorts by
    global id, so member lists come out ascending — the single-process
    member order — and the returned ``HostRowTable`` holds exactly the
    rows of the owned blocks.
    """
    me = comm.rank
    labels = blocks.labels
    dest = host_of_block[labels] if labels.size else np.empty(0, np.int64)
    gids = pstore.start + np.arange(pstore.n_local, dtype=np.int64)
    payloads = {}
    # One bulk local read, then slice per destination (bounded by the
    # partition size, which is the point of the partitioned store).
    if labels.size:
        xw, yw = pstore.parent.read_slice(pstore.start, pstore.stop)
        for h in range(comm.size):
            sel = np.nonzero(dest == h)[0]
            if sel.size:
                payloads[h] = {"ids": gids[sel], "lab": labels[sel],
                               "x": xw[sel], "y": yw[sel]}
    got = comm.exchange(payloads)

    bc = blocks.n_blocks
    if got:
        gid = np.concatenate([p["ids"] for p in got.values()])
        lab = np.concatenate([p["lab"] for p in got.values()])
        xr = np.concatenate([p["x"] for p in got.values()])
        yr = np.concatenate([p["y"] for p in got.values()])
        order = np.argsort(gid, kind="stable")
        gid, lab, xr, yr = gid[order], lab[order], xr[order], yr[order]
    else:
        gid = np.empty(0, np.int64)
        lab = np.empty(0, np.int64)
        xr = np.empty((0, pstore.d))
        yr = np.empty(0)
    by_block = np.argsort(lab, kind="stable")
    counts = np.bincount(lab, minlength=bc)
    splits = np.split(gid[by_block], np.cumsum(counts)[:-1])
    for b in np.nonzero(host_of_block == me)[0]:
        blocks.members[int(b)] = splits[b].astype(np.int64)
    table = HostRowTable(pstore.d)
    table.add(gid, xr, yr)
    return table


class _HaloMiss(Exception):
    """A candidate block's members aren't resident yet (needs a fetch)."""

    def __init__(self, missing):
        super().__init__(f"missing blocks {sorted(missing)[:8]}")
        self.missing = list(missing)


class _IdFlatView:
    """Virtual ``flat_idx``: flat position -> global row id, served from
    per-block id arrays (no O(n) replicated index array per host)."""

    def __init__(self, starts: np.ndarray, ids: dict):
        self._starts = starts
        self._ids = ids

    def __getitem__(self, pos):
        pos = np.asarray(pos, np.int64)
        scalar = pos.ndim == 0
        p = np.atleast_1d(pos)
        out = np.empty(p.size, np.int64)
        blk = np.searchsorted(self._starts, p, side="right") - 1
        for b in np.unique(blk):
            ids = self._ids.get(int(b))
            if ids is None:
                raise _HaloMiss([int(b)])
            sel = blk == b
            out[sel] = ids[p[sel] - self._starts[b]]
        return out[0] if scalar else out


class HaloFlatBlocks:
    """`_FlatBlocks` interface over owned + halo-fetched blocks.

    Index bookkeeping (sizes/starts/radii) is GLOBAL — it derives from
    the replicated k-means summaries, O(bc) per host. Member ids and
    scaled coordinates exist only for owned blocks (lazily scaled from
    the row table) and for halo blocks ingested by `_fetch_halo`; asking
    for any other block raises `_HaloMiss`, which the NNS sweep turns
    into the next halo-exchange round. Because `_one_block` sees the
    exact same candidate admission, concat order, and coordinates as the
    single-process sweep, the neighbor lists match it exactly wherever
    the (eps-level) center differences don't flip a tie.
    """

    def __init__(self, sizes: np.ndarray, radii: np.ndarray, n_rows: int,
                 d: int, table: HostRowTable, members: list,
                 host_of_block: np.ndarray, rank: int):
        self.sizes = np.asarray(sizes, np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.sizes)])
        self.radii = np.asarray(radii)
        self.n_rows = int(n_rows)
        self.d = int(d)
        self._table = table
        self._ids: dict[int, np.ndarray] = {
            int(b): members[int(b)]
            for b in np.nonzero(host_of_block == rank)[0]
        }
        self._owned = set(self._ids)
        self._coords: dict[int, np.ndarray] = {}
        self._beta = None  # set by the sweep before any gather
        self.halo_rows = 0
        self.halo_blocks = 0
        self.flat_idx = _IdFlatView(self.starts, self._ids)

    def has_block(self, b: int) -> bool:
        return int(b) in self._ids

    def ingest(self, b: int, ids: np.ndarray, pts_scaled: np.ndarray) -> None:
        b = int(b)
        if b in self._ids:
            return
        self._ids[b] = np.asarray(ids, np.int64)
        self._coords[b] = pts_scaled
        self.halo_rows += int(ids.size)
        self.halo_blocks += 1

    def rows_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        if block_ids.size == 0:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(
            [np.arange(self.starts[b], self.starts[b + 1]) for b in block_ids]
        )

    def _coords_of(self, b: int) -> np.ndarray:
        b = int(b)
        pts = self._coords.get(b)
        if pts is None:
            ids = self._ids.get(b)
            if ids is None:
                raise _HaloMiss([b])
            pts = scale_inputs(self._table.read_rows(ids)[0], self._beta)
            self._coords[b] = pts
        return pts

    def points_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        if block_ids.size == 0:
            return np.empty((0, self.d))
        missing = [int(b) for b in block_ids if int(b) not in self._ids]
        if missing:
            raise _HaloMiss(missing)
        out = [self._coords_of(b) for b in block_ids]
        return out[0] if len(out) == 1 else np.concatenate(out)


def _fetch_halo(comm, needs, flat: HaloFlatBlocks, members: list,
                table: HostRowTable, host_of_block, beta) -> None:
    """One lockstep halo-exchange round (request + reply alltoalls).

    COLLECTIVE: all hosts must call together, `needs` may be empty.
    Requested blocks are served by their owners from the row table
    (member order = ascending global ids, same as local blocks); arrivals
    are ingested into the flat index AND the row table, so both the NNS
    retry and the later packing see them.
    """
    req: dict[int, list] = {}
    for b in needs:
        req.setdefault(int(host_of_block[b]), []).append(int(b))
    got = comm.exchange({
        h: {"blocks": np.asarray(sorted(bs), np.int64)}
        for h, bs in req.items() if h != comm.rank
    })
    replies = {}
    for src, p in got.items():
        bids = p["blocks"]
        mlists = [members[int(b)] for b in bids]
        sizes = np.asarray([mm.size for mm in mlists], np.int64)
        ids = (np.concatenate(mlists) if mlists else np.empty(0, np.int64))
        xg, yg = table.read_rows(ids)
        replies[src] = {"blocks": bids, "sizes": sizes,
                        "ids": ids, "x": xg, "y": yg}
    got2 = comm.exchange(replies)
    for p in got2.values():
        off = 0
        new_ids, new_x, new_y = [], [], []
        for b, sz in zip(p["blocks"], p["sizes"]):
            sz = int(sz)
            ids_b = p["ids"][off:off + sz]
            if not flat.has_block(int(b)):
                flat.ingest(int(b), ids_b,
                            scale_inputs(p["x"][off:off + sz], beta))
                members[int(b)] = ids_b.astype(np.int64)
                new_ids.append(ids_b)
                new_x.append(p["x"][off:off + sz])
                new_y.append(p["y"][off:off + sz])
            off += sz
        if new_ids:
            table.add(np.concatenate(new_ids), np.concatenate(new_x),
                      np.concatenate(new_y))


def multihost_filtered_nns(
    blocks: BlockStructure, sizes: np.ndarray, radii: np.ndarray,
    table: HostRowTable, host_of_block: np.ndarray, beta: np.ndarray,
    m: int, comm, alpha: float = 100.0, domain_volume: float = 1.0,
):
    """Per-host filtered NNS over owned query blocks with halo exchange.

    Round 0 proactively fetches every foreign preceding block the coarse
    filter admits at the base Eq. 7 radius (computable from replicated
    centers/radii alone — the Alg. 2 candidate exchange); the doubling
    fallback inside `_one_block` then drives additional lockstep rounds
    only for queries whose ball came up short. All hosts run the same
    number of exchange rounds (an all-reduce counts outstanding misses),
    so no host can deadlock waiting for a peer.
    """
    me = comm.rank
    bc = blocks.n_blocks
    centers = blocks.centers
    ranks = blocks.rank_of_block
    n, d = int(np.sum(sizes)), centers.shape[1] if bc else table.d
    lam = nns_radius(n, m, d, domain_volume, alpha)
    flat = HaloFlatBlocks(sizes, radii, n, d, table, blocks.members,
                          host_of_block, me)
    flat._beta = np.broadcast_to(np.asarray(beta, np.float64), (d,))
    c2 = np.sum(centers * centers, axis=1)

    owned_q = [int(b) for b in np.nonzero(host_of_block == me)[0]
               if ranks[b] > 0]
    # Center distances with the EXACT chunked expression of the
    # single-process `filtered_nns` sweep (same center_chunk grid, same
    # GEMM shapes), so a LoopbackComm run reproduces its floats bitwise.
    center_chunk = max(16, min(2048, MAX_D2_ENTRIES // max(bc, 1)))
    dist_cache: dict[int, np.ndarray] = {}
    owned_set = set(owned_q)
    for s in range(0, bc, center_chunk):
        e = min(bc, s + center_chunk)
        if not owned_set.intersection(range(s, e)):
            continue
        q = centers[s:e]
        dc = np.sum(q * q, axis=1)[:, None] - 2.0 * q @ centers.T + c2[None, :]
        np.sqrt(np.maximum(dc, 0.0, out=dc), out=dc)
        for bi in range(s, e):
            if bi in owned_set:
                dist_cache[bi] = dc[bi - s]

    # Round 0: the admitted-at-lam candidate exchange.
    needs = set()
    for bi in owned_q:
        keep = (dist_cache[bi] <= lam + radii) & (ranks < ranks[bi])
        for j in np.nonzero(keep)[0]:
            j = int(j)
            if not flat.has_block(j):
                needs.add(j)
    _fetch_halo(comm, needs, flat, blocks.members, table, host_of_block, beta)

    neigh: list = [np.empty(0, np.int64)] * bc
    pending = owned_q
    rounds = 1
    while True:
        misses: set[int] = set()
        still = []
        for bi in pending:
            try:
                neigh[bi] = _one_block(bi, centers[bi], dist_cache[bi], lam,
                                       m, ranks, flat)
            except _HaloMiss as e:
                misses.update(int(b) for b in e.missing)
                still.append(bi)
        outstanding = comm.allreduce_scalar(float(len(misses)))
        if outstanding == 0:
            break
        _fetch_halo(comm, misses, flat, blocks.members, table,
                    host_of_block, beta)
        pending = still
        rounds += 1
        if rounds > 64:
            raise RuntimeError("halo-exchange NNS failed to converge")
    stats = {"halo_rounds": rounds, "halo_blocks": flat.halo_blocks,
             "halo_rows": flat.halo_rows}
    return neigh, flat, stats


def multihost_preprocess(
    pstore, beta: np.ndarray, cfg, stream_chunk: int, comm,
    struct_batch: int | None = None,
) -> MultihostStructure:
    """The multi-process `streaming_preprocess`: every stage holds only
    this host's share (partition windows, owned-block rows, admitted halo
    blocks) while the replicated summaries stay O(bc)."""
    bytes0 = getattr(comm, "bytes_sent", 0) + getattr(comm, "bytes_recv", 0)
    secs0 = getattr(comm, "exchange_s", 0.0)
    blocks, radii, vol, host_of_block, sizes = multihost_kmeans_blocks(
        pstore, beta, cfg.n_blocks, comm, seed=cfg.seed,
        batch_rows=struct_batch or DEFAULT_STRUCT_BATCH,
        ordering=cfg.ordering,
    )
    table = _membership_exchange(pstore, blocks, host_of_block, comm)
    owned_rows = table.n_rows
    neigh, _flat, halo_stats = multihost_filtered_nns(
        blocks, sizes, radii, table, host_of_block, beta, cfg.m, comm,
        alpha=cfg.alpha, domain_volume=vol,
    )
    owned_ranks = np.sort(blocks.rank_of_block[host_of_block == comm.rank])
    plan = plan_block_chunks(blocks, neigh, cfg.m, stream_chunk,
                             ranks=owned_ranks)
    bs_max = int(sizes.max()) if sizes.size else 0
    if cfg.bs_max is not None:
        bs_max = max(bs_max, cfg.bs_max)
    stats = {
        "n_hosts": comm.size, "rank": comm.rank,
        "rows_local": pstore.n_local, "owned_rows": owned_rows,
        "owned_blocks": int(np.sum(host_of_block == comm.rank)),
        "exchange_bytes": getattr(comm, "bytes_sent", 0)
        + getattr(comm, "bytes_recv", 0) - bytes0,
        "exchange_s": getattr(comm, "exchange_s", 0.0) - secs0,
        **halo_stats,
    }
    return MultihostStructure(
        blocks=blocks, neigh=neigh, table=table,
        host_of_block=host_of_block, sizes=sizes, domain_volume=vol,
        plan=plan, bs_max=bs_max, stats=stats,
    )


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

    MULTI-HOST runs (``stream_stats`` carrying ``n_hosts > 1`` from the
    multihost fit) get the reference's PER-HOST version of the n-scaled
    terms: the NNS scan and index arrays cover only the rows this host can
    touch (owned-block rows + ingested halo rows), and two terms are added,
    the resident ``HostRowTable`` (+ exchange transients) and the
    partition-pass window spike of the membership exchange.

    On a CUDA ``device`` the device-grad and device-spool terms live in
    device memory: they are returned under ``device_terms`` and left out
    of ``terms`` and ``total``, which then model host RSS alone.

    The same constants applied to the WHOLE dataset give
    ``incore_total``: what the monolithic path would hold resident.
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
    if st.get("n_hosts", 1) > 1:
        resident = int(st["owned_rows"]) + int(st.get("halo_rows", 0))
        terms["nns_scan"] = 3 * resident * d * 8
        terms["index_arrays"] = 4 * resident * 8 + st["bc"] * m * 8
        terms["row_table"] = 3 * resident * (d + 2) * 8
        terms["partition_pass"] = 3 * int(st["rows_local"]) * (d + 1) * 8
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
