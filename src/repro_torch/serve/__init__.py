"""Serving tier of the port: greedy and sampled generation on the port's
Loop-of-stencil-reduce (-s variant), continuous batching and the
request batcher."""
from .batcher import Batcher, Request, Result
from .engine import (ContinuousEngine, GenerateConfig, generate, prefill,
                     request_budget)

__all__ = ["Batcher", "ContinuousEngine", "GenerateConfig", "Request",
           "Result", "generate", "prefill", "request_budget"]
