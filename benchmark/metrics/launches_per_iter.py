"""launches_per_iter: device kernels (graph replays' kernels included) per
lockstep iteration in the profiled slice."""


def read(run):
    tr = run.trace
    if tr is None or tr["iterations"] == 0:
        return None
    return len(tr["kernels"]) / tr["iterations"]
