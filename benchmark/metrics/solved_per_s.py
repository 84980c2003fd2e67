"""solved_per_s: instances converged to the configuration's tolerance over
the window's seconds (host clock, whole batches)."""


def read(run):
    return run.solved / run.window_s
