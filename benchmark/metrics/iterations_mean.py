"""iterations_mean: the solver's iterations (accepted steps, the returned
`Solution.iterations`) averaged over every instance of the window."""


def read(run):
    return sum(b["iterations_sum"] for b in run.batches) / run.attempted
