"""Host-side preprocessing: scaling + partitioning (Alg. 2), RAC (Alg. 3).

The paper runs these once on CPU before the iterated GPU likelihood loop;
we do the same (numpy). "Workers" are the P shards of the device mesh —
the MPI_Alltoall of Alg. 2 becomes a host-side permutation that assigns
each point an owner shard, giving the same locality property: points that
are close in the *scaled* space land on the same worker.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def scale_inputs(x: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """x_ij := x_ij / beta_j (Alg. 2 line 4)."""
    return np.asarray(x, dtype=np.float64) / np.asarray(beta, dtype=np.float64)


def most_relevant_dim(beta: np.ndarray) -> int:
    """The partitioning dimension d' of Alg. 2.

    The paper prints ``argmax beta_i`` but its Fig. 2 and the bucket formula
    ``int(x * P * beta_{d'})`` (which needs x*beta in [0,1), i.e. x in the
    *scaled* space) both partition along the dimension with the LARGEST
    scaled extent == smallest beta == highest relevance 1/beta. We resolve
    the typo in favor of argmin(beta); see DESIGN.md.
    """
    return int(np.argmin(np.asarray(beta)))


def partition_points(x_scaled: np.ndarray, n_workers: int, beta: np.ndarray) -> np.ndarray:
    """Assign each point an owner worker by its d'-coordinate (Alg. 2 line 7).

    Returns owner ids in [0, n_workers). Equal-mass bucketing via quantiles
    keeps workers balanced even for non-uniform inputs (the paper's
    fixed-width ``int(x * P * beta)`` buckets assume uniformity; quantile
    buckets preserve its locality while guaranteeing balance).
    """
    dprime = most_relevant_dim(beta)
    coord = x_scaled[:, dprime]
    # Quantile edges -> near-equal worker loads.
    qs = np.quantile(coord, np.linspace(0.0, 1.0, n_workers + 1)[1:-1])
    owners = np.searchsorted(qs, coord, side="right")
    return owners.astype(np.int32)


def rac_cluster(x_scaled: np.ndarray, n_blocks: int, rng: np.random.Generator, chunk: int = 65536) -> np.ndarray:
    """Random Anchor Clustering (Alg. 3): labels in [0, n_blocks).

    Anchors are n_blocks points drawn without replacement; every point joins
    its nearest anchor (in scaled space). O(n * n_blocks) done in chunks.
    """
    n = x_scaled.shape[0]
    n_blocks = min(n_blocks, n)
    anchor_idx = rng.choice(n, size=n_blocks, replace=False)
    anchors = x_scaled[anchor_idx]  # (K, d)
    a2 = np.sum(anchors * anchors, axis=1)
    labels = np.empty(n, dtype=np.int64)
    for s in range(0, n, chunk):
        xs = x_scaled[s : s + chunk]
        d2 = np.sum(xs * xs, axis=1)[:, None] - 2.0 * xs @ anchors.T + a2[None, :]
        labels[s : s + chunk] = np.argmin(d2, axis=1)
    return labels


def kmeans_cluster(
    x_scaled: np.ndarray, n_blocks: int, rng: np.random.Generator, iters: int = 10
) -> np.ndarray:
    """K-means alternative (the BV paper's choice; RAC replaces it in SBV)."""
    labels = rac_cluster(x_scaled, n_blocks, rng)
    x = x_scaled
    for _ in range(iters):
        centers = np.zeros((n_blocks, x.shape[1]))
        counts = np.bincount(labels, minlength=n_blocks).astype(np.float64)
        np.add.at(centers, labels, x)
        nonempty = counts > 0
        centers[nonempty] /= counts[nonempty, None]
        # Re-seed empty clusters at random points.
        n_empty = int((~nonempty).sum())
        if n_empty:
            centers[~nonempty] = x[rng.choice(x.shape[0], size=n_empty, replace=False)]
        c2 = np.sum(centers * centers, axis=1)
        d2 = np.sum(x * x, axis=1)[:, None] - 2.0 * x @ centers.T + c2[None, :]
        new_labels = np.argmin(d2, axis=1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


@dataclass
class BlockStructure:
    """Block decomposition of a dataset in scaled space."""

    labels: np.ndarray            # (n,) block id per point
    order: np.ndarray             # (bc,) block ids in conditioning order
    rank_of_block: np.ndarray     # (bc,) rank[block_id] = position in order
    centers: np.ndarray           # (bc, d) block centroids (scaled space)
    owners: np.ndarray            # (bc,) owner worker per block
    members: list = field(default_factory=list)  # list of index arrays per block id

    @property
    def n_blocks(self) -> int:
        return len(self.order)


def build_blocks(
    x_scaled: np.ndarray,
    n_blocks: int,
    n_workers: int,
    beta: np.ndarray,
    seed: int = 0,
    method: str = "rac",
    ordering: str = "random",
) -> BlockStructure:
    """Partition points to workers, cluster per worker, order blocks.

    Per the paper, clustering is local to each worker (no communication) and
    block ordering is a random permutation. ``ordering='coord'`` (sort block
    centers along d') is kept as a beyond-paper option — it tends to improve
    neighbor quality for near-1D-relevant problems.
    """
    rng = np.random.default_rng(seed)
    n = x_scaled.shape[0]
    owners_pt = partition_points(x_scaled, n_workers, beta)

    labels = np.full(n, -1, dtype=np.int64)
    block_owner = []
    next_block = 0
    for p in range(n_workers):
        idx = np.nonzero(owners_pt == p)[0]
        if idx.size == 0:
            continue
        k_p = max(1, int(round(n_blocks * idx.size / n)))
        k_p = min(k_p, idx.size)
        cluster_fn = rac_cluster if method == "rac" else kmeans_cluster
        local = cluster_fn(x_scaled[idx], k_p, rng)
        # Drop empty local clusters, compact ids.
        uniq, local = np.unique(local, return_inverse=True)
        labels[idx] = local + next_block
        next_block += uniq.size
        block_owner.extend([p] * uniq.size)

    bc = next_block
    members = [np.nonzero(labels == b)[0] for b in range(bc)]
    centers = np.stack([x_scaled[mb].mean(axis=0) for mb in members])

    if ordering == "random":
        order = rng.permutation(bc)
    elif ordering == "coord":
        order = np.argsort(centers[:, most_relevant_dim(beta)], kind="stable")
    elif ordering == "maxmin":
        order = _maxmin_order(centers, rng)
    else:
        raise ValueError(f"unknown ordering {ordering!r}")
    rank_of_block = np.empty(bc, dtype=np.int64)
    rank_of_block[order] = np.arange(bc)

    return BlockStructure(
        labels=labels,
        order=np.asarray(order, dtype=np.int64),
        rank_of_block=rank_of_block,
        centers=centers,
        owners=np.asarray(block_owner, dtype=np.int32),
        members=members,
    )


def _maxmin_order(centers: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Greedy max-min ordering of block centers (Guinness 2018 style)."""
    k = centers.shape[0]
    start = int(rng.integers(k))
    chosen = [start]
    d2 = np.sum((centers - centers[start]) ** 2, axis=1)
    d2[start] = -np.inf
    for _ in range(k - 1):
        nxt = int(np.argmax(d2))
        chosen.append(nxt)
        nd2 = np.sum((centers - centers[nxt]) ** 2, axis=1)
        d2 = np.minimum(d2, nd2)
        d2[nxt] = -np.inf
    return np.asarray(chosen, dtype=np.int64)
