"""Roofline terms of the dry run's cells (``analysis.roofline``)."""
from .roofline import DEFAULT_HW, HW, CellReport, model_flops, roofline

__all__ = ["CellReport", "DEFAULT_HW", "HW", "model_flops", "roofline"]
