"""Serving tier of the port: greedy and sampled generation on the port's
Loop-of-stencil-reduce (-s variant), compiled generation (a decode step
captured as a CUDA graph), continuous batching and the request batcher."""
from .batcher import Batcher, Request, Result
from .engine import (CHECK_EVERY, ContinuousEngine, GenerateConfig,
                     GenerateJit, generate, generate_jit, prefill,
                     request_budget)
from .graphs import StepGraph

__all__ = ["Batcher", "CHECK_EVERY", "ContinuousEngine", "GenerateConfig",
           "GenerateJit", "Request", "Result", "StepGraph", "generate",
           "generate_jit", "prefill", "request_budget"]
