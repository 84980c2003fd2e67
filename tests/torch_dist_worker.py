"""One rank of the port's two-rank CPU run
(`tests/test_torch_parallel_dist.py`).

Spawned by the test, never collected by pytest: it imports `torch` and the
port only. It joins a gloo process group through a `FileStore` file (no TCP
port), drives the `parallel/` layer on inputs the test wrote, and saves
what it got as `rank<r>.npz`.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import ipddp2tpu_torch as P
from ipddp2tpu_torch.models import concar, double_integrator as di
from ipddp2tpu_torch.parallel import (make_mesh, solve_sharded,
                                      value_scan_timesharded)
from ipddp2tpu_torch.parallel.multihost import (initialize_distributed,
                                                solve_global)
from ipddp2tpu_torch.parallel.priccati import ValueElement
from ipddp2tpu_torch.parallel.timeshard import solve_timesharded
from ipddp2tpu_torch.problem import Bounds, uniform_bounds

SOLVE_ITERATIONS = 3
DI_T = 64
CONCAR_T = 16
CONCAR_B = 4


def di_long(T=DI_T):
    """The double integrator at horizon T with its bounds, start and first
    guess (tests/test_timeshard.py's long-horizon case)."""
    prob = dataclasses.replace(di.problem(), T=T)
    inf = float("inf")
    lo = torch.tensor([-di.FORCE_LIMIT, 0.0, 0.0], dtype=torch.float64)
    hi = torch.tensor([di.FORCE_LIMIT, inf, inf], dtype=torch.float64)
    return (prob, uniform_bounds(T, lo, hi), di.initial_state()[None],
            torch.full((1, T, di.NU), 0.01, dtype=torch.float64))


def concar_instance(i, T=CONCAR_T):
    """Global instance i of the sharded concar batch, from its own seed
    (the reference generator's ranges): (bounds [T, nu], x1, u0, theta),
    without a batch axis. Generated by index alone, so a rank can make
    just its own."""
    rng = np.random.default_rng(1000 + i)
    f_lim = 1.5 + rng.uniform()
    tau_lim = 3.0 + 2.0 * rng.uniform()
    centers = np.array([[0.25, 0.25], [0.75, 0.75], [0.25, 0.75],
                        [0.75, 0.25]])
    xy = centers + (rng.uniform(size=(4, 2)) - 0.5) * 0.2
    r = 0.05 + rng.uniform(size=4) * 0.15
    x1 = np.zeros(4)
    x1[2] = np.pi / 8 + rng.uniform() * np.pi / 4
    b = concar.bounds(torch.tensor([f_lim]), torch.tensor([tau_lim]))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return (Bounds(b.lower[0, :T], b.upper[0, :T]), t(x1),
            concar.initial_controls()[:T],
            concar.Theta(t(np.concatenate([xy, r[:, None]], axis=1))))


def short_concar(T=CONCAR_T):
    return dataclasses.replace(concar.problem(), T=T)


GENERATED = []


def generate(i):
    GENERATED.append(i)
    return concar_instance(i)


def stack_instances(items):
    b, x, u, th = zip(*items)
    return (Bounds(torch.stack([a.lower for a in b]),
                   torch.stack([a.upper for a in b])),
            torch.stack(x), torch.stack(u),
            concar.Theta(torch.stack([a.obstacles for a in th])))


def options():
    return P.Options(optimality_tolerance=1e-7,
                     max_iterations=SOLVE_ITERATIONS)


def run(rank, world, store_file, work_dir):
    torch.set_num_threads(1)
    work = Path(work_dir)
    initialize_distributed(init_method=f"file://{store_file}",
                           world_size=world, rank=rank, device="cpu")
    out = {}
    try:
        # the time-sharded value scan on the elements the test wrote
        data = np.load(work / "elements.npz")
        el = ValueElement(*(torch.as_tensor(data[k])
                            for k in ValueElement._fields))
        prob = types.SimpleNamespace(T=el.A.shape[1], nx=el.A.shape[-1])
        sp = make_mesh(axis="sp")
        out["Vx"], out["Vxx"] = value_scan_timesharded(
            prob, el, torch.as_tensor(data["lTx"]),
            torch.as_tensor(data["lTxx"]), sp)
        # one solve with its value scan sharded over time
        sol = solve_timesharded(*di_long(), options=options(), mesh=sp,
                                device="cpu")
        out["ts_x"], out["ts_u"] = sol.x, sol.u
        # the batch sharded over ranks, and generated by each rank
        dp = make_mesh()
        batch = stack_instances([concar_instance(i)
                                 for i in range(CONCAR_B)])
        for tag, (sol, stats) in (
                ("sh", solve_sharded(short_concar(), *batch[:3],
                                     theta=batch[3], options=options(),
                                     mesh=dp, device="cpu")),
                ("gl", solve_global(short_concar(), generate, CONCAR_B,
                                    options=options(), mesh=dp,
                                    device="cpu"))):
            for f in ("x", "u", "iterations", "status", "converged"):
                out[f"{tag}_{f}"] = getattr(sol, f)
            out[f"{tag}_stats"] = torch.stack([
                torch.as_tensor(v, dtype=torch.float64) for v in stats])
        out["generated"] = torch.tensor(GENERATED)
    finally:
        dist.destroy_process_group()
    np.savez(work / f"rank{rank}.npz",
             **{k: v.numpy() for k, v in out.items()})
