"""End-to-end SBV preprocessing (paper Alg. 1 steps 1-3, host-side).

scale -> partition to workers -> RAC -> order -> filtered NNS -> pack.
Executed once on CPU (as in the paper); the packed result is what the
device-side likelihood iterates over.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .blocks import BlockStructure, build_blocks, scale_inputs
from .nns import brute_force_nns, filtered_nns
from .packing import PackedBlocks, pack_blocks


@dataclass
class SBVConfig:
    """Preprocessing hyper-parameters (paper Table 1 notation)."""

    n_blocks: int            # bc: total block count K
    m: int                   # m_est: nearest neighbors per block
    n_workers: int = 1       # P: shards of the device mesh
    alpha: float = 100.0     # NNS expansion factor (Eq. 7)
    seed: int = 0
    clustering: str = "rac"  # 'rac' (paper) | 'kmeans' (BV paper)
    ordering: str = "random" # 'random' (paper) | 'coord' | 'maxmin'
    nns: str = "filtered"    # 'filtered' (paper) | 'brute' (oracle)
    bs_max: int | None = None
    dtype: type = np.float64


def preprocess(
    x: np.ndarray, y: np.ndarray, beta: np.ndarray, cfg: SBVConfig
) -> tuple[PackedBlocks, BlockStructure]:
    """Full SBV preprocessing with scaling parameters ``beta``.

    ``beta`` shapes only the block/NN structure; raw coordinates are packed
    so the likelihood stays differentiable in the kernel's own beta.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    beta = np.broadcast_to(np.asarray(beta, dtype=np.float64), (x.shape[1],))
    xs = scale_inputs(x, beta)
    blocks = build_blocks(
        xs,
        n_blocks=cfg.n_blocks,
        n_workers=cfg.n_workers,
        beta=beta,
        seed=cfg.seed,
        method=cfg.clustering,
        ordering=cfg.ordering,
    )
    if cfg.nns == "filtered":
        neigh = filtered_nns(xs, blocks, cfg.m, alpha=cfg.alpha)
    elif cfg.nns == "brute":
        neigh = brute_force_nns(xs, blocks, cfg.m)
    else:
        raise ValueError(f"unknown nns method {cfg.nns!r}")
    packed = pack_blocks(x, y, blocks, neigh, cfg.m, bs_max=cfg.bs_max, dtype=cfg.dtype)
    return packed, blocks
