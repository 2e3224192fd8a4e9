from .blocks import BlockStructure, build_blocks, scale_inputs
from .exact_gp import exact_logdet, exact_loglik, exact_predict
from .kernels_math import KernelParams, cast_params, cov_matrix, matern
from .packing import PackedBlocks, PackedPrediction, pack_blocks, pack_prediction
from .pipeline import SBVConfig, preprocess
from .kl import kl_divergence

__all__ = [
    "BlockStructure", "build_blocks", "scale_inputs", "KernelParams", "cast_params",
    "cov_matrix", "matern", "PackedBlocks", "PackedPrediction", "pack_blocks",
    "pack_prediction", "SBVConfig", "preprocess", "exact_logdet", "exact_loglik",
    "exact_predict", "kl_divergence",
]
