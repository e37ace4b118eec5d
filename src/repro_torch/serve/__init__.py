"""Serving engine of the port: greedy generation on the port's
Loop-of-stencil-reduce (-s variant)."""
from .engine import GenerateConfig, generate, prefill

__all__ = ["GenerateConfig", "generate", "prefill"]
