"""Roofline (port of ``repro.roofline``): per-chip FLOPs, bytes and
collective bytes of a step (``op_count``, the counterpart of the
reference's HLO walk) against the H100's peaks (``analysis``), and the
dry-run's tables (``report``)."""
from .analysis import HW, model_flops, roofline_report
from .op_count import OpCounter, op_cost_analysis

__all__ = ["HW", "OpCounter", "model_flops", "op_cost_analysis",
           "roofline_report"]
