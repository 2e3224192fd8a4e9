"""Filtered m-nearest-neighbor search (paper Alg. 4 + Eq. 7).

A numpy copy of ``repro.core.nns``: the same seeds give the same lists.

For every block (query = its center, in scaled space) we need the m nearest
*points* drawn from blocks that come EARLIER in the conditioning order.
The paper avoids a full O(n) scan per query with a two-stage filter:

  coarse: keep candidate blocks near the query center (their MPI_Alltoall
          candidate exchange);
  fine:   keep candidate points within radius lambda of the query center;
  exact:  brute-force top-m among survivors.

lambda (Eq. 7) is chosen so a ball of radius lambda holds ~ alpha * m
points under a uniform density. Two robustness upgrades over the printed
algorithm (DESIGN.md §3):

* the density estimate is explicit (bounding-box volume of the scaled
  inputs) instead of assuming a unit domain, so the formula survives
  arbitrary beta;
* the coarse filter admits block j when dist(c_i, c_j) <= lambda +
  radius_j (radius_j = max member distance to its center), which makes the
  two-stage filter EXACT: every point within lambda of the query is
  guaranteed to survive to the fine stage. A doubling fallback handles
  balls that come up short of m points.
"""
from __future__ import annotations

import math

import numpy as np

from .blocks import BlockStructure


def unit_ball_volume(d: int) -> float:
    return math.pi ** (d / 2.0) / math.gamma(d / 2.0 + 1.0)


def nns_radius(n: int, m: int, d: int, domain_volume: float, alpha: float = 100.0) -> float:
    """Eq. 7 with explicit domain volume: ball(lambda) ~ alpha*m points."""
    target_frac = min(1.0, alpha * m / max(n, 1))
    lam_d = target_frac * domain_volume / unit_ball_volume(d)
    return lam_d ** (1.0 / d)


def _scaled_domain_volume(x_scaled: np.ndarray) -> float:
    ext = x_scaled.max(axis=0) - x_scaled.min(axis=0)
    med = np.median(ext[ext > 0]) if np.any(ext > 0) else 1.0
    ext = np.maximum(ext, 1e-6 * med)  # guard constant dims
    return float(np.prod(ext))


class _FlatBlocks:
    """Block members flattened once for fast candidate slicing.

    The NNS loops below touch members only through ``rows_of_blocks`` /
    ``points_of_blocks``, so the store-backed twin with the same bookkeeping
    (``repro_torch.data.streaming.LazyFlatBlocks``) runs them unchanged.
    """

    def __init__(self, x_scaled: np.ndarray, blocks: BlockStructure):
        sizes = np.asarray([mb.size for mb in blocks.members], dtype=np.int64)
        self.sizes = sizes
        self.starts = np.concatenate([[0], np.cumsum(sizes)])
        self.flat_idx = (
            np.concatenate(blocks.members) if blocks.n_blocks else np.empty(0, np.int64)
        )
        self.flat_pts = x_scaled[self.flat_idx]
        self.flat_rank = np.repeat(blocks.rank_of_block, sizes)
        self.n_rows = x_scaled.shape[0]
        self.d = x_scaled.shape[1]
        # Block radius: max member distance to the block center.
        self.radii = np.array(
            [
                np.sqrt(np.max(np.sum((x_scaled[mb] - c) ** 2, axis=1))) if mb.size else 0.0
                for mb, c in zip(blocks.members, blocks.centers)
            ]
        )

    def rows_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        if block_ids.size == 0:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(
            [np.arange(self.starts[b], self.starts[b + 1]) for b in block_ids]
        )

    def points_of_blocks(self, block_ids: np.ndarray) -> np.ndarray:
        """Scaled member coordinates of the given blocks, concatenated in
        block order (row-aligned with ``rows_of_blocks(block_ids)``)."""
        if block_ids.size == 0:
            return np.empty((0, self.d))
        if block_ids.size == 1:
            b = int(block_ids[0])
            return self.flat_pts[self.starts[b]:self.starts[b + 1]]
        return np.concatenate(
            [self.flat_pts[self.starts[b]:self.starts[b + 1]] for b in block_ids]
        )


def filtered_nns(
    x_scaled: np.ndarray | None,
    blocks: BlockStructure,
    m: int,
    alpha: float = 100.0,
    center_chunk: int = 2048,
    flat: _FlatBlocks | None = None,
    domain_volume: float | None = None,
) -> list[np.ndarray]:
    """Exact preceding-block m-NNS per block via filtered candidate sets.

    Returns ``neigh[b]`` = global point indices (up to m; fewer for
    early-ordered blocks) sorted by distance to the center of block b.
    ``flat`` lets callers reuse a prebuilt ``_FlatBlocks`` of
    ``(x_scaled, blocks)`` — building one does a full n x d gather.
    Streaming callers pass ``x_scaled=None`` with a store-backed ``flat``
    plus a precomputed ``domain_volume`` (chunk-accumulated min/max extent
    gives the same floats as the in-core formula).
    """
    if flat is None:
        flat = _FlatBlocks(x_scaled, blocks)
    bc = blocks.n_blocks
    n, d = flat.n_rows, flat.d
    if domain_volume is None:
        domain_volume = _scaled_domain_volume(x_scaled)
    lam = nns_radius(n, m, d, domain_volume, alpha)

    centers = blocks.centers
    ranks = blocks.rank_of_block
    c2 = np.sum(centers * centers, axis=1)
    neigh: list[np.ndarray] = [np.empty(0, np.int64)] * bc

    for s in range(0, bc, center_chunk):
        e = min(bc, s + center_chunk)
        q = centers[s:e]
        dc = np.sum(q * q, axis=1)[:, None] - 2.0 * q @ centers.T + c2[None, :]
        np.sqrt(np.maximum(dc, 0.0, out=dc), out=dc)
        for bi in range(s, e):
            if ranks[bi] > 0:
                neigh[bi] = _one_block(bi, centers[bi], dc[bi - s], lam, m, ranks, flat)
    return neigh


def _topm(rows: np.ndarray, d2p: np.ndarray, m: int, flat: _FlatBlocks) -> np.ndarray:
    k = min(m, rows.size)
    if rows.size > k:
        part = np.argpartition(d2p, k - 1)[:k]
    else:
        part = np.arange(rows.size)
    part = part[np.argsort(d2p[part], kind="stable")]
    return flat.flat_idx[rows[part]].astype(np.int64)


def _one_block(bi, center, dist_c, lam, m, ranks, flat) -> np.ndarray:
    my_rank = ranks[bi]
    n_prec = int(my_rank)  # number of preceding blocks
    lam_try = lam
    for _ in range(40):
        keep = (dist_c <= lam_try + flat.radii) & (ranks < my_rank)
        cand_blocks = np.nonzero(keep)[0]
        covered = cand_blocks.size >= n_prec
        if cand_blocks.size:
            rows = flat.rows_of_blocks(cand_blocks)
            d2p = np.sum((flat.points_of_blocks(cand_blocks) - center) ** 2, axis=1)
            fine = d2p <= lam_try * lam_try
            n_fine = int(fine.sum())
            if n_fine >= m:
                return _topm(rows[fine], d2p[fine], m, flat)
            if covered:
                # Whole preceding set is already candidate: brute is exact.
                return _topm(rows, d2p, m, flat)
        elif covered:  # no preceding blocks at all
            return np.empty(0, dtype=np.int64)
        lam_try *= 2.0
    raise RuntimeError("filtered NNS failed to converge (degenerate geometry?)")


def filtered_knn_points(
    x_scaled: np.ndarray | None,
    blocks: BlockStructure,
    queries: np.ndarray,
    m: int,
    alpha: float = 100.0,
    center_chunk: int = 2048,
    flat: _FlatBlocks | None = None,
    domain_volume: float | None = None,
) -> list[np.ndarray]:
    """Unconstrained k-NN of arbitrary query points against ALL training
    points, via the same coarse(block)/fine(point) filter. Used by the
    prediction stage (Eq. 3: NN(B_j^*) drawn from the full training set).

    ``flat`` lets chunked/persistent serving reuse one ``_FlatBlocks`` of
    the training set instead of re-flattening (a full n x d gather) per
    query chunk. Store-backed indexes pass ``x_scaled=None`` with a lazy
    ``flat`` and a cached ``domain_volume`` (see ``TrainIndex``)."""
    if flat is None:
        flat = _FlatBlocks(x_scaled, blocks)
    n, d = flat.n_rows, flat.d
    nq = queries.shape[0]
    if domain_volume is None:
        domain_volume = _scaled_domain_volume(x_scaled)
    lam = nns_radius(n, m, d, domain_volume, alpha)
    centers = blocks.centers
    c2 = np.sum(centers * centers, axis=1)
    bc = blocks.n_blocks
    out: list[np.ndarray] = [np.empty(0, np.int64)] * nq

    for s in range(0, nq, center_chunk):
        e = min(nq, s + center_chunk)
        q = queries[s:e]
        dc = np.sum(q * q, axis=1)[:, None] - 2.0 * q @ centers.T + c2[None, :]
        np.sqrt(np.maximum(dc, 0.0, out=dc), out=dc)
        for qi in range(s, e):
            lam_try = lam
            for _ in range(40):
                keep = dc[qi - s] <= lam_try + flat.radii
                cand = np.nonzero(keep)[0]
                covered = cand.size >= bc
                if cand.size:
                    rows = flat.rows_of_blocks(cand)
                    d2p = np.sum((flat.points_of_blocks(cand) - queries[qi]) ** 2, axis=1)
                    fine = d2p <= lam_try * lam_try
                    if int(fine.sum()) >= m:
                        out[qi] = _topm(rows[fine], d2p[fine], m, flat)
                        break
                    if covered:
                        out[qi] = _topm(rows, d2p, m, flat)
                        break
                lam_try *= 2.0
            else:
                raise RuntimeError("filtered kNN failed to converge")
    return out


def brute_force_nns(x_scaled: np.ndarray, blocks: BlockStructure, m: int) -> list[np.ndarray]:
    """Reference O(n)-per-query implementation (test oracle)."""
    ranks = blocks.rank_of_block
    pt_rank = ranks[blocks.labels]
    out = []
    for b in range(blocks.n_blocks):
        rows = np.nonzero(pt_rank < ranks[b])[0]
        if rows.size == 0:
            out.append(np.empty(0, dtype=np.int64))
            continue
        d2 = np.sum((x_scaled[rows] - blocks.centers[b]) ** 2, axis=1)
        k = min(m, rows.size)
        part = np.argpartition(d2, k - 1)[:k] if rows.size > k else np.arange(rows.size)
        part = part[np.argsort(d2[part], kind="stable")]
        out.append(rows[part].astype(np.int64))
    return out
