"""Per-layer metric readers, one file a metric, found by name; each
``read(ctx)`` returns the value, or None where the run has nothing to
read."""
