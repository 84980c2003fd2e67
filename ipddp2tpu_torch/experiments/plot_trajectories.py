"""Seed-1 trajectories of five models, solved and drawn (PyTorch port).

Counterpart of `experiments/plot_trajectories.py`, in two halves.

The solving half, `trajectories(name, device)`, runs the JAX script's
solve of one model through `ipddp2tpu_torch.solve` (B = 1) on `device`:
concar, cartpole and acrobot (contact), and pushing on their seed-1
instances, the quadrotor on its default instance, each at the JAX
script's tolerance (1e-7; the quadrotor 1e-6). On a GPU that runs the
sweep kernel: the LDL^T sweep for concar and the quadrotor, the
Bunch-Kaufman sweep for the three contact models. It returns numpy arrays
(x, u, iterations, objective, converged, status, and the parameters the
drawing needs) and `main` saves them as `<out>/<stem>.npz`.

The drawing half, `draw(name, data, out)`, draws the JAX script's figure
of that model from such a file into `<out>/<stem>.png`. It imports
matplotlib when it is called: without it, drawing raises `ImportError`,
and `--no-draw` writes only the `.npz` (on a GPU host without
matplotlib; draw its files elsewhere).

Usage:
    python3 -m ipddp2tpu_torch.experiments.plot_trajectories
        [concar|cartpole|acrobot|quadrotor|pushing ...]
        [--device cuda|cpu] [--out plots_out] [--no-draw]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from ..models import acrobot, cartpole, concar, pushing, quadrotor
from ..options import Options
from ..problem import Bounds
from ..solve import resolve_device, solve

NAMES = ("concar", "cartpole", "acrobot", "quadrotor", "pushing")
# the JAX script's file names (without extension)
STEMS = {"concar": "concar_seed1", "cartpole": "cartpole_friction_seed1",
         "acrobot": "acrobot_contact_seed1", "quadrotor": "quadrotor",
         "pushing": "pushing_1_obs_seed1"}
MODELS = {"concar": concar, "cartpole": cartpole, "acrobot": acrobot,
          "quadrotor": quadrotor, "pushing": pushing}
# the JAX script's tolerance of each solve
TOLERANCE = {"quadrotor": 1e-6}
OUT = "plots_out"


def instance(name, device=None, T=None):
    """(problem, bounds, x1, u0, theta) of the JAX script's instance of
    `name`, unbatched, at horizon `T` (default the model's)."""
    m = MODELS[name]
    T = m.T if T is None else T
    if name == "concar":
        theta, f_lim, tau_lim, x1 = m.seed1_instance(device=device)
        bounds = m.bounds(f_lim, tau_lim, device=device)
    elif name == "quadrotor":
        theta, x1 = m.default_instance(device=device)
        bounds = m.bounds(device=device)
    else:
        theta, x1 = m.seed1_instance(device=device), m.initial_state(
            device=device)
        bounds = m.bounds(device=device)
    problem = dataclasses.replace(m.problem(), T=T)
    bounds = Bounds(bounds.lower[:T], bounds.upper[:T])
    return problem, bounds, x1, m.initial_controls(device=device)[:T], theta


def options(name) -> Options:
    return Options(optimality_tolerance=TOLERANCE.get(name, 1e-7))


def trajectories(name, device=None, T=None) -> dict:
    """The solving half: `name`'s seed-1 solve (B = 1) on `device` (the
    default GPU raises without one), as a dict of numpy arrays: x [T+1,
    nx], u [T, nu], iterations, objective, converged, status, and
    `theta_<field>` for each field of the instance's parameters."""
    device = resolve_device(device)
    problem, bounds, x1, u0, theta = instance(name, device, T)
    batch = lambda a: a[None]
    sol = solve(problem, Bounds(batch(bounds.lower), batch(bounds.upper)),
                batch(x1), batch(u0),
                theta=type(theta)(*(batch(a) for a in theta)),
                options=options(name), device=device)
    host = lambda a: a[0].detach().cpu().numpy()
    data = dict(name=np.array(name), x=host(sol.x), u=host(sol.u),
                iterations=host(sol.iterations), objective=host(sol.objective),
                converged=host(sol.converged), status=host(sol.status))
    for field, value in zip(theta._fields, theta):
        data[f"theta_{field}"] = value.detach().cpu().numpy()
    return data


def save(data, out) -> Path:
    """`data` as `<out>/<stem>.npz`."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{STEMS[str(data['name'])]}.npz"
    np.savez(path, **data)
    return path


def load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError without it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "drawing needs matplotlib, which is not installed; pass "
            "--no-draw to write only the .npz files") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw(name, data, out) -> Path:
    """The drawing half: the JAX script's figure of `name` from `data` (a
    dict of `trajectories`, or the path of its `.npz`) into
    `<out>/<stem>.png`."""
    plt = pyplot()
    if not isinstance(data, dict):
        data = load(data)
    m = MODELS[name]
    x, u = data["x"], data["u"]
    its, obj = int(data["iterations"]), float(data["objective"])
    t = np.arange(u.shape[0]) * m.DT
    if name == "concar":
        fig, ax = plt.subplots(figsize=(6, 6))
        for ox, oy, r in data["theta_obstacles"]:
            ax.add_patch(plt.Circle((ox, oy), r, color="tab:red", alpha=0.4))
        ax.plot(x[:, 0], x[:, 1], "-o", ms=2, color="tab:blue")
        ax.plot(*m.X_GOAL[:2], "*", ms=15, color="gold")
        ax.set_xlim(-0.1, 1.1)
        ax.set_ylim(-0.1, 1.1)
        ax.set_title(f"concar seed 1 — {its} iters, J={obj:.4f}")
    elif name == "cartpole":
        qdot = (x[:-1, 2:4] - x[:-1, 0:2]) / m.DT
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(t, qdot[:, 0], label="cart velocity")
        ax.plot(t, qdot[:, 1], label="pole velocity")
        ax.plot(t, u[:, 0], label="force", color="tab:green")
        ax.plot(t, u[:, 3] - u[:, 4], "--", label="slider friction impulse")
        ax.plot(t, u[:, 5] - u[:, 6], "--", label="hinge friction impulse")
        ax.legend()
        ax.set_xlabel("t")
        ax.set_title(f"cartpole friction seed 1 — {its} iters")
    elif name == "acrobot":
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(t, 0.5 * np.pi - x[:-1, 3], label="gap upper")
        ax.plot(t, x[:-1, 3] + 0.5 * np.pi, label="gap lower")
        ax.plot(t, u[:, 3], "--", label="lambda 1")
        ax.plot(t, u[:, 4], "--", label="lambda 2")
        ax.set_ylim(0, 5)
        ax.legend()
        ax.set_title(f"acrobot contact seed 1 — {its} iters")
    elif name == "quadrotor":
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot(x[:, 0], x[:, 1], x[:, 2])
        ax.scatter(*data["theta_goal"], marker="*", s=120, color="gold")
        ax.set_title(f"quadrotor — {its} iters")
    else:
        obs = data["theta_obstacle"]
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        ax = axes[0]
        ax.add_patch(plt.Circle((obs[0], obs[1]), obs[2], color="tab:red",
                                alpha=0.4))
        ax.plot(x[:, 0], x[:, 1], "-o", ms=2, color="tab:blue")
        ax.plot(*m.X_GOAL[:2], "*", ms=15, color="gold")
        ax.set_aspect("equal")
        ax.set_title("slider path")
        ax = axes[1]
        ax.plot(t, u[:, 0], label="normal force")
        ax.plot(t, u[:, 1], label="tangential force")
        ax.plot(t, x[:-1, 3], label="contact angle phi")
        ax.legend()
        ax.set_title("contact signals")
        fig.suptitle(f"pushing_1_obs seed 1 — {its} iters, J={obj:.5f}")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{STEMS[name]}.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--no-draw", action="store_true",
                    help="solve and write the .npz files only")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in MODELS]
    if unknown:
        ap.error(f"unknown model(s) {unknown}; expected {list(NAMES)}")
    device = resolve_device(args.device)
    if not args.no_draw:
        pyplot()                  # before the solves: fail early without it
    for name in args.names:
        data = trajectories(name, device)
        print(f"{name}: {int(data['iterations'])} iterations, objective "
              f"{float(data['objective']):.8e}, converged "
              f"{bool(data['converged'])} -> {save(data, args.out)}",
              flush=True)
        if not args.no_draw:
            print("wrote", draw(name, data, args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
