"""Instances of concar_quad, drawn with the ranges of the upstream generator
(concar.jl:31-47, the same for concar_quad), which the configuration file
holds: control limits f_lim and tau_lim, four obstacles (a centre jittered
about its corner of the unit square, a radius) and the initial heading.

`draw` returns float64 CPU tensors: theta by the field names of the
configuration's `Theta`, x1 [n, nx], control bounds [n, nu] (the same at
every stage).
"""

import torch


def draw(cfg, n, gen):
    r = cfg["ranges"]
    rand = lambda *shape: torch.rand(shape, generator=gen,
                                     dtype=torch.float64)
    span = lambda lim, u: lim[0] + (lim[1] - lim[0]) * u
    f_lim = span(r["f_lim"], rand(n))
    tau_lim = span(r["tau_lim"], rand(n))
    centers = torch.tensor(r["obstacle_centers"], dtype=torch.float64)
    xy = centers + span(r["obstacle_center_offset"], rand(n, 4, 2))
    radius = span(r["obstacle_radius"], rand(n, 4))
    x1 = torch.tensor([0.0 if v is None else v for v in r["x1"]],
                      dtype=torch.float64).repeat(n, 1)
    x1[:, 2] = span(r["x1_heading"], rand(n))
    slack = 2 * 4
    lower = torch.cat([-f_lim[:, None], -tau_lim[:, None],
                       torch.zeros(n, slack, dtype=torch.float64)], dim=1)
    upper = torch.cat([f_lim[:, None], tau_lim[:, None],
                       torch.full((n, slack), float("inf"),
                                  dtype=torch.float64)], dim=1)
    theta = {"obstacles": torch.cat([xy, radius[..., None]], dim=-1)}
    return {"theta": theta, "x1": x1, "lower": lower, "upper": upper}
