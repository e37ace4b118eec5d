"""Bytes a sweep of the stencil kernel needs, from the frame's shape.

Each input byte is counted once and each output byte once, whatever the
kernel reads again (halo rows, re-staged windows): a sweep of radius ``k``
over an (m, n) frame of ``elem``-byte values reads the grid and its
``n_env`` read-only fields and writes the new grid.  The per-lane reduce
(one value a frame) and the ghost ring are left out.
"""


def sweep_bytes(m: int, n: int, n_env: int = 0, elem: int = 4) -> int:
    """Bytes one sweep of one frame needs: (1 + n_env) reads, one write."""
    return (2 + n_env) * m * n * elem


def restore_sweep_bytes(m: int, n: int, elem: int = 4) -> int:
    """The §4.3 restoration sweep: the grid and two fields (the repaired
    observation and the noise mask) read, the new grid written."""
    return sweep_bytes(m, n, n_env=2, elem=elem)
