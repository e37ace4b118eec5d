"""Runnable examples of the port (twins of the top-level ``examples/``)."""
