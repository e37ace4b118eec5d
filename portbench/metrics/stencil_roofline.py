"""Share of its roofline that the stencil kernel's restoration sweeps
reach in the traced slice, in percent: the bytes the slice's useful sweeps
need (``counts/stencil.py``: each lane step of a frame reads the grid and
two fields and writes the grid) over the HBM peak times the summed device
time of the kernel's restoration instantiation (``window_kernel`` with the
``Restore`` functor).  Useful lane steps are read from the farm's counters
at the slice's first and last segment boundaries."""
from portbench.counts import peaks, stencil
from portbench.trace import kernel_seconds


def read(ctx):
    s, steps = ctx.get("trace"), ctx.get("traced_useful_lane_steps")
    if not s or not steps:
        return None
    t = kernel_seconds(s, "window_kernel", "Restore")
    if t <= 0:
        return None
    m, n = ctx["frame"]
    need = steps * stencil.restore_sweep_bytes(m, n)
    return 100.0 * need / (peaks.HBM_BYTES * t)
