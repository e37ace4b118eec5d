"""Training-side entry points of the port (this slice: the evaluation
loss only)."""
