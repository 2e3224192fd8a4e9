"""Assigned input-shape set (same four shapes for every LM arch) and the
(arch x shape) applicability rule."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only the attention-free /
# hybrid archs run it (DESIGN.md §4). All assigned archs are decoder-only,
# so no decode-shape skips beyond this one.
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    spec = SHAPES[shape_name]
    if spec.name == "long_500k" and cfg.family not in _LONG_OK_FAMILIES:
        return False, (
            f"{cfg.name} is pure full-attention ({cfg.family}); 500k-context "
            "decode has no sub-quadratic mechanism in the published arch — skipped"
        )
    return True, ""
