"""sweep_ms_per_iter: device milliseconds of the backward sweep kernels
(`backward_sweep*`, every attempt of the regularization ladder) per
lockstep iteration in the profiled slice."""

from devicetrace import kernel_time


def read(run):
    tr = run.trace
    if tr is None or tr["iterations"] == 0:
        return None
    n, seconds = kernel_time(tr, "backward_sweep")
    return 1e3 * seconds / tr["iterations"] if n else None
