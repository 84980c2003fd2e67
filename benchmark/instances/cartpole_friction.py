"""Instances of cartpole_friction, drawn with the ranges of the upstream
generator (cartpole_friction.jl:37-42), which the configuration file holds:
cart mass, pole mass, pole length and the two friction coefficients. Every
instance starts at rest at the origin; |F| <= the force limit, q+ free,
every contact variable and slack nonnegative.

`draw` returns float64 CPU tensors: theta by the field names of the
configuration's `Theta`, x1 [n, nx], control bounds [n, nu].
"""

import torch


def draw(cfg, n, gen):
    r = cfg["ranges"]
    rand = lambda *shape: torch.rand(shape, generator=gen,
                                     dtype=torch.float64)
    span = lambda lim, u: lim[0] + (lim[1] - lim[0]) * u
    theta = {"mc": span(r["mc"], rand(n)), "mp": span(r["mp"], rand(n)),
             "l": span(r["l"], rand(n)),
             "friction": span(r["friction"], rand(n, 2))}
    nu, inf = cfg["nu"], float("inf")
    f = r["force_limit"]
    lower = torch.tensor([-f, -inf, -inf] + [0.0] * (nu - 3),
                         dtype=torch.float64).repeat(n, 1)
    upper = torch.tensor([f] + [inf] * (nu - 1),
                         dtype=torch.float64).repeat(n, 1)
    x1 = torch.tensor(r["x1"], dtype=torch.float64).repeat(n, 1)
    return {"theta": theta, "x1": x1, "lower": lower, "upper": upper}
