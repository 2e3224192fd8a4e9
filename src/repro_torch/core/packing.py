"""Pack irregular blocks + neighbor sets into fixed-size padded arrays.

A numpy copy of ``repro.core.packing`` (bitwise-identical packed arrays).
MAGMA (the paper's GPU backend) supports variable-size batched BLAS; the
fused kernels here take fixed shapes. We pad every block to ``bs_max`` rows
and every neighbor set to ``m`` rows and carry boolean masks. The
likelihood kernel applies *identity padding*: padded rows/cols of each
covariance get a unit diagonal and zero off-diagonals, padded observations
are zero, and only real points contribute the -0.5*log(2*pi) constant —
provably (and test-verifiably) leaving the likelihood unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .blocks import BlockStructure


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _check_neighbors(nb: np.ndarray, b: int, n_source: int) -> np.ndarray:
    """Validate one block's neighbor index list before it is gathered.

    A fixed-width neighbor array padded with sentinels (-1, or repeats of
    the last index) would pass silently through ``x[nb]`` — negative
    indices wrap around in numpy — and be packed as REAL rows with
    ``nn_mask=True``, corrupting the likelihood with no error anywhere
    downstream. Packing therefore only accepts true (unpadded) index
    lists: under-full blocks must arrive SHORT, and the packer masks the
    tail itself."""
    nb = np.asarray(nb)
    if nb.ndim != 1:
        raise ValueError(f"block {b}: neighbor list must be 1-D, got shape {nb.shape}")
    if nb.size and (int(nb.min()) < 0 or int(nb.max()) >= n_source):
        raise ValueError(
            f"block {b}: neighbor indices outside [0, {n_source}) — pass true "
            "(unpadded) neighbor lists; sentinel padding would be gathered as "
            "real rows and masked True"
        )
    if np.unique(nb).size != nb.size:
        raise ValueError(
            f"block {b}: duplicate neighbor indices — repeat-of-last-index "
            "padding would gather duplicate conditioning rows (near-singular "
            "covariance); true kNN lists never repeat"
        )
    return nb


@dataclass
class PackedBlocks:
    """Device-ready SoA layout. All arrays leading dim = bc (block count).

    Coordinates are stored RAW (unscaled): the scaling parameters beta live
    in the kernel parameters so that gradients flow through them. The
    preprocessing-time beta only shapes the block/neighbor structure.
    """

    blk_x: np.ndarray    # (bc, bs_max, d)
    blk_y: np.ndarray    # (bc, bs_max) or (bc, bs_max, p) multi-output
    blk_mask: np.ndarray  # (bc, bs_max) bool
    nn_x: np.ndarray     # (bc, m, d)
    nn_y: np.ndarray     # (bc, m) or (bc, m, p) multi-output
    nn_mask: np.ndarray  # (bc, m) bool
    owners: np.ndarray   # (bc,) worker id per block

    @property
    def n_blocks(self) -> int:
        return self.blk_x.shape[0]

    @property
    def bs_max(self) -> int:
        return self.blk_x.shape[1]

    @property
    def m(self) -> int:
        return self.nn_x.shape[1]

    @property
    def n_points(self) -> int:
        return int(self.blk_mask.sum())

    @property
    def n_outputs(self) -> int:
        """1 for the single-output layout, p for (bc, bs, p) observations."""
        return 1 if self.blk_y.ndim == 2 else int(self.blk_y.shape[2])

    def pad_to_blocks(self, bc_target: int) -> "PackedBlocks":
        """Append fully-masked dummy blocks (for even sharding)."""
        extra = bc_target - self.n_blocks
        if extra <= 0:
            return self
        z = lambda a: np.concatenate(
            [a, np.zeros((extra,) + a.shape[1:], dtype=a.dtype)], axis=0
        )
        return PackedBlocks(
            blk_x=z(self.blk_x), blk_y=z(self.blk_y), blk_mask=z(self.blk_mask),
            nn_x=z(self.nn_x), nn_y=z(self.nn_y), nn_mask=z(self.nn_mask),
            owners=z(self.owners),
        )


@dataclass
class PackedPrediction:
    """Device-ready layout for block prediction (paper Eq. 3).

    Prediction blocks are query (test) blocks; each conditions on its
    m_pred nearest TRAINING points. Same identity-padding contract as
    ``PackedBlocks``: padded neighbor rows factor through the conditional
    as the identity, padded query columns produce mu=0 / var=prior and are
    dropped at scatter time via ``q_mask``/``q_idx``.
    """

    q_x: np.ndarray      # (bc, bs_pred, d) raw query coords
    q_mask: np.ndarray   # (bc, bs_pred) bool
    q_idx: np.ndarray    # (bc, bs_pred) int32 global test index (0 on pads)
    nn_x: np.ndarray     # (bc, m_pred, d) raw training-neighbor coords
    nn_y: np.ndarray     # (bc, m_pred)
    nn_mask: np.ndarray  # (bc, m_pred) bool
    owners: np.ndarray   # (bc,) worker id per block

    @property
    def n_blocks(self) -> int:
        return self.q_x.shape[0]

    @property
    def bs_pred(self) -> int:
        return self.q_x.shape[1]

    @property
    def m_pred(self) -> int:
        return self.nn_x.shape[1]

    @property
    def n_queries(self) -> int:
        return int(self.q_mask.sum())

    @property
    def n_outputs(self) -> int:
        """1 for the single-output layout, p for (bc, m, p) observations."""
        return 1 if self.nn_y.ndim == 2 else int(self.nn_y.shape[2])

    def arrays(self) -> tuple:
        """The five device operands of the batched predict kernels."""
        return self.q_x, self.q_mask, self.nn_x, self.nn_y, self.nn_mask

    def pad_to_blocks(self, bc_target: int) -> "PackedPrediction":
        """Append fully-masked dummy blocks (even sharding / jit-shape reuse)."""
        extra = bc_target - self.n_blocks
        if extra <= 0:
            return self
        z = lambda a: np.concatenate(
            [a, np.zeros((extra,) + a.shape[1:], dtype=a.dtype)], axis=0
        )
        return PackedPrediction(
            q_x=z(self.q_x), q_mask=z(self.q_mask), q_idx=z(self.q_idx),
            nn_x=z(self.nn_x), nn_y=z(self.nn_y), nn_mask=z(self.nn_mask),
            owners=z(self.owners),
        )


def pack_prediction(
    x_test: np.ndarray,
    x_train: np.ndarray,
    y_train: np.ndarray,
    test_blocks: BlockStructure,
    neighbors: list[np.ndarray],
    m_pred: int,
    bs_max: int | None = None,
    dtype=np.float64,
) -> PackedPrediction:
    """Pack prediction blocks + per-block training neighbors into padded
    arrays. ``neighbors[b]`` indexes ``x_train`` (full training set, no
    ordering constraint — Eq. 3 conditions on the training vector y)."""
    bc = test_blocks.n_blocks
    d = x_test.shape[1]
    if bs_max is None:
        bs_max = max(mb.size for mb in test_blocks.members)

    q_x = np.zeros((bc, bs_max, d), dtype=dtype)
    q_mask = np.zeros((bc, bs_max), dtype=bool)
    q_idx = np.zeros((bc, bs_max), dtype=np.int32)
    nn_x = np.zeros((bc, m_pred, d), dtype=dtype)
    # Multi-output observations ((n, p) y) carry their output axis into
    # the packed layout; the 1-D layout is bitwise-unchanged.
    nn_y = np.zeros((bc, m_pred) + y_train.shape[1:], dtype=dtype)
    nn_mask = np.zeros((bc, m_pred), dtype=bool)
    owners = np.zeros(bc, dtype=np.int32)

    for b in range(bc):
        mb = test_blocks.members[b]
        if mb.size > bs_max:
            raise ValueError(f"prediction block {b} size {mb.size} > bs_max {bs_max}")
        q_x[b, : mb.size] = x_test[mb]
        q_mask[b, : mb.size] = True
        q_idx[b, : mb.size] = mb
        nb = _check_neighbors(neighbors[b], b, x_train.shape[0])[:m_pred]
        nn_x[b, : nb.size] = x_train[nb]
        nn_y[b, : nb.size] = y_train[nb]
        nn_mask[b, : nb.size] = True
        owners[b] = test_blocks.owners[b]
    return PackedPrediction(q_x, q_mask, q_idx, nn_x, nn_y, nn_mask, owners)


def pack_blocks(
    x_raw: np.ndarray,
    y: np.ndarray,
    blocks: BlockStructure,
    neighbors: list[np.ndarray],
    m: int,
    bs_max: int | None = None,
    dtype=np.float64,
) -> PackedBlocks:
    """Pack (x, y, block structure, neighbor lists) into padded arrays,
    ordered by conditioning rank (block 0 of the output = first block)."""
    bc = blocks.n_blocks
    d = x_raw.shape[1]
    if bs_max is None:
        bs_max = max(mb.size for mb in blocks.members)

    blk_x = np.zeros((bc, bs_max, d), dtype=dtype)
    # Multi-output observations ((n, p) y) carry their output axis into
    # the packed layout; the 1-D layout is bitwise-unchanged.
    blk_y = np.zeros((bc, bs_max) + y.shape[1:], dtype=dtype)
    blk_mask = np.zeros((bc, bs_max), dtype=bool)
    nn_x = np.zeros((bc, m, d), dtype=dtype)
    nn_y = np.zeros((bc, m) + y.shape[1:], dtype=dtype)
    nn_mask = np.zeros((bc, m), dtype=bool)
    owners = np.zeros(bc, dtype=np.int32)

    for rank, b in enumerate(blocks.order):
        mb = blocks.members[b]
        if mb.size > bs_max:
            raise ValueError(f"block {b} size {mb.size} > bs_max {bs_max}")
        blk_x[rank, : mb.size] = x_raw[mb]
        blk_y[rank, : mb.size] = y[mb]
        blk_mask[rank, : mb.size] = True
        nb = _check_neighbors(neighbors[b], b, x_raw.shape[0])[:m]
        nn_x[rank, : nb.size] = x_raw[nb]
        nn_y[rank, : nb.size] = y[nb]
        nn_mask[rank, : nb.size] = True
        owners[rank] = blocks.owners[b]
    return PackedBlocks(blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, owners)
