"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

One command runs one cell once::

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  ``BENCHMARK.json`` at the root of the
checkout names the cells; everything that belongs to one of them is found
by name:

* a configuration: ``configs/<config>.json`` (its ``driver`` key names
  ``drivers/<driver>.py``, the code that runs that kind of system);
* a traffic mix: ``traffic/<traffic>.json`` (its ``generator`` key names
  ``traffic/<generator>.py``);
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(ctx)`` returns
  the value or None where the run has nothing to read;
* the operations and bytes a kernel or a step needs: ``counts/``;
* the plain references that decide ``correct``: ``reference/``.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; ``reference/`` imports nothing of the port either.
"""
