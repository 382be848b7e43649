"""LM serving (port of ``repro.serve``): the continuous batcher and the
engine that runs the port's ``DecoderLM.decode_step`` over a slot arena."""

from .batching import ContinuousBatcher
from .engine import Request, ServeEngine, ServeReport

__all__ = ["ServeEngine", "ServeReport", "Request", "ContinuousBatcher"]
