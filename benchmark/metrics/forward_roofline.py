"""forward_roofline: the least time of the slice's forward kernels (the
metrics kernel's K candidates and the trial kernel's rollout, each over the
cell's whole batch: `roofline.metrics_bound_s`, `trial_bound_s`) over their
device time, in percent. Only the speculative and hybrid searches launch
them."""

from devicetrace import kernel_time
from roofline import metrics_bound_s, trial_bound_s


def read(run):
    if run.trace is None:
        return None
    n3, t3 = kernel_time(run.trace, "forward_metrics")
    n4, t4 = kernel_time(run.trace, "forward_trial")
    if n3 + n4 == 0 or t3 + t4 <= 0:
        return None
    lanes, K = run.batches[0]["lanes"], run.options.ls_speculative
    least = (n3 * metrics_bound_s(run.cfg, lanes, K)
             + n4 * trial_bound_s(run.cfg, lanes))
    return 100.0 * least / (t3 + t4)
