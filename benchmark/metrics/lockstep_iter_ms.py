"""lockstep_iter_ms: the host's milliseconds per lockstep iteration (the
solver loop's passes) over the iterations that ran before the process
first profiled: every batch of an untraced run, the first batch's
iterations before its first profiled slice in a traced one (profiling
leaves every later launch slower)."""


def read(run):
    seconds = sum(b["unprofiled_s"] for b in run.batches)
    its = sum(b["unprofiled_iterations"] for b in run.batches)
    return 1e3 * seconds / its if its > 0 else None
