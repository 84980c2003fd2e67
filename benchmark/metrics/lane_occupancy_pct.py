"""lane_occupancy_pct: lane-iterations that took a step (the `trace=` list
of `solve.run`) over lanes x lockstep iterations, over the window. The rest
is work the lockstep loop does on lanes that have stopped or wait."""


def read(run):
    slots = sum(b["lanes"] * b["lockstep_iterations"] for b in run.batches)
    return 100.0 * sum(b["stepped"] for b in run.batches) / slots
