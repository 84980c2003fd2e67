"""sweep_roofline: the least time of the slice's backward sweeps (each over
the cell's whole batch, its work from the configuration's shapes and stage
solve: `roofline.sweep_bound_s`) over their device time, in percent."""

from devicetrace import kernel_time
from roofline import sweep_bound_s


def read(run):
    if run.trace is None:
        return None
    n, seconds = kernel_time(run.trace, "backward_sweep")
    if n == 0 or seconds <= 0:
        return None
    lanes = run.batches[0]["lanes"]
    return 100.0 * n * sweep_bound_s(run.cfg, lanes) / seconds
