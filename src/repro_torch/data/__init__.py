"""The port's data pipeline (twin of :mod:`repro.data`)."""
from .pipeline import Prefetcher, SyntheticLM, shard_batch

__all__ = ["SyntheticLM", "Prefetcher", "shard_batch"]
