"""Roofline terms of a dry-run cell: the counterpart of the non-HLO half of
``repro.analysis.hlo_analysis`` (``model_flops``, ``CellReport``,
``roofline``).

Two terms per (arch x shape x mesh) cell, in seconds per step on one
device of the mesh, from the card's published figures (``HW``: an NVIDIA
H100 80GB HBM3, bf16 dense 989 TFLOP/s, HBM 3.35 TB/s, 80 GB), so they are
reckoned, not measured:

    compute = step FLOPs / devices / peak FLOP/s
    memory  = bytes a device holds (params, optimiser state, cache) / HBM rate

The step FLOPs are what ``torch.utils.flop_counter.FlopCounterMode`` counts
over the step run on ``meta`` (``launch.dryrun``): matrix products only,
with the plain attention's dense S x T products where the card runs the
causal flash kernel. The memory term reads each resident byte once, a floor.

The reference's third term, collective bytes, and its trip-count-aware cost
model (``collective_bytes``, ``analysis/hlo_cost.py``) parse XLA's
optimized HLO text. The port has no HLO and runs a model on one device, so
they have no counterpart here (``tests/test_hlo_cost.py`` stays with the
reference).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class HW:
    """Per-card peak numbers (NVIDIA H100 80GB HBM3, published figures)."""

    name: str = "NVIDIA H100 80GB HBM3"
    peak_flops: float = 989e12      # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12         # bytes/s
    hbm_bytes: float = 80e9         # capacity


DEFAULT_HW = HW()


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs per step: 6*N*D (dense) / 6*N_active*D (MoE),
    N = non-embedding params, D = processed tokens. Decode steps process
    global_batch tokens; train processes batch*seq and costs 3x forward."""
    from repro_torch.launch.param_count import active_param_count

    n_active = active_param_count(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    toks = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * toks


@dataclass
class CellReport:
    """One cell: its step's counted FLOPs (whole mesh) and the bytes one
    device holds under the cell's specs (``peak_memory``: their sum, no
    activations)."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float
    param_bytes: float
    state_bytes: float
    cache_bytes: float
    peak_memory: float
    model_flops: float = 0.0
    hw: HW = DEFAULT_HW
    extra: dict = field(default_factory=dict)

    @property
    def flops_per_dev(self) -> float:
        return self.flops / self.n_devices

    @property
    def bytes_per_dev(self) -> float:
        return self.param_bytes + self.state_bytes + self.cache_bytes

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def fits(self) -> bool:
        return self.peak_memory <= self.hw.hbm_bytes

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS / (devices * peak * t_step)."""
        denom = self.n_devices * self.hw.peak_flops * self.t_step
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices, "flops": self.flops,
            "flops_per_dev": self.flops_per_dev, "param_bytes": self.param_bytes,
            "state_bytes": self.state_bytes, "cache_bytes": self.cache_bytes,
            "bytes_per_dev": self.bytes_per_dev, "peak_memory": self.peak_memory,
            "fits": self.fits, "hw": self.hw.name, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory, "t_step": self.t_step,
            "bottleneck": self.bottleneck, "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction, "extra": self.extra,
        }


def roofline(report: CellReport) -> str:
    """One summary line."""
    r = report
    return (
        f"{r.arch:>20s} {r.shape:>12s} {r.mesh:>9s} | "
        f"comp {r.t_compute*1e3:9.3f}ms  mem {r.t_memory*1e3:9.3f}ms | {r.bottleneck:8s} | "
        f"useful {r.useful_ratio*100:5.1f}%  roofline-MFU {r.roofline_fraction*100:5.1f}% "
        f"(reckoned for {r.hw.name})"
    )
