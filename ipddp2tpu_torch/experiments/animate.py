"""Seed-1 trajectories as GIFs (PyTorch port).

Counterpart of `experiments/animate.py` (`animate_cartpole`,
`animate_acrobot`, `animate_concar`): the cart and its pole, the double
pendulum, the car among its obstacles. It draws from the `.npz` files that
`plot_trajectories` writes (`--from DIR`) and solves again, through
`plot_trajectories.trajectories` on `--device`, only where a file is
absent. `frame(name, data, i, ax)` draws one frame; `animate` writes every
frame into `<out>/<stem>.gif` through matplotlib's `FuncAnimation` and
`PillowWriter`. matplotlib is imported when drawing; without it this
script raises `ImportError`.

Usage:
    python3 -m ipddp2tpu_torch.experiments.animate
        [cartpole|acrobot|concar ...] [--from plots_out]
        [--device cuda|cpu] [--out plots_out] [--fps 25]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..models import concar
from ..solve import resolve_device
from . import plot_trajectories as pt

NAMES = ("cartpole", "acrobot", "concar")
FIGSIZE = {"cartpole": (6, 4), "acrobot": (5, 5), "concar": (5, 5)}


def frame(name, data, i, ax):
    """Draw frame `i` of `name`'s trajectory (`data`: the arrays of
    `plot_trajectories.trajectories`) on `ax`, cleared first; returns the
    moving artists."""
    ax.clear()
    ax.set_aspect("equal")
    x = data["x"]
    if name == "cartpole":
        q = x[:, 2:4]                        # the next-configuration half
        length = float(data["theta_l"])
        ax.set_xlim(-2.0, 2.0)
        ax.set_ylim(-0.8, 0.8)
        ax.axhline(0, color="gray", lw=0.5)
        cx, th = q[i]
        px, py = cx + length * np.sin(th), -length * np.cos(th)
        cart, = ax.plot([cx], [0.0], "s", ms=18, color="tab:blue")
        pole, = ax.plot([cx, px], [0.0, py], "-o", lw=2, color="tab:orange")
        return cart, pole
    if name == "acrobot":
        q = x[:, 2:4]
        l1, l2 = float(data["theta_l1"]), float(data["theta_l2"])
        lim = l1 + l2 + 0.2
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        a, b = q[i]
        x1, y1 = l1 * np.sin(a), -l1 * np.cos(a)
        x2, y2 = x1 + l2 * np.sin(a + b), y1 - l2 * np.cos(a + b)
        links, = ax.plot([0, x1, x2], [0, y1, y2], "-o", lw=3,
                         color="tab:blue")
        return (links,)
    plt = pt.pyplot()
    for ox, oy, r in data["theta_obstacles"]:
        ax.add_patch(plt.Circle((ox, oy), r, color="tab:red", alpha=0.4))
    ax.plot(*concar.X_GOAL[:2], "*", ms=15, color="gold")
    ax.set_xlim(-0.1, 1.1)
    ax.set_ylim(-0.1, 1.1)
    trail, = ax.plot(x[:i + 1, 0], x[:i + 1, 1], "-", lw=1, color="tab:blue")
    car, = ax.plot([x[i, 0]], [x[i, 1]], "o", ms=8, color="tab:blue")
    nose, = ax.plot([x[i, 0], x[i, 0] + 0.04 * np.cos(x[i, 2])],
                    [x[i, 1], x[i, 1] + 0.04 * np.sin(x[i, 2])], "-", lw=2,
                    color="tab:blue")
    return trail, car, nose


def animate(name, data, out, fps=25) -> Path:
    """Every frame of `name` into `<out>/<stem>.gif`."""
    plt = pt.pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter
    fig, ax = plt.subplots(figsize=FIGSIZE[name])
    anim = FuncAnimation(fig, lambda i: frame(name, data, i, ax),
                         frames=len(data["x"]))
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{pt.STEMS[name]}.gif"
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def trajectory(name, source, device):
    """`name`'s arrays from `<source>/<stem>.npz`, or solved on `device`
    (and saved there) where that file is absent."""
    path = Path(source) / f"{pt.STEMS[name]}.npz"
    if path.exists():
        return pt.load(path)
    data = pt.trajectories(name, device)
    pt.save(data, source)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--from", dest="source", default=pt.OUT,
                    help="directory of plot_trajectories' .npz files")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=pt.OUT)
    ap.add_argument("--fps", type=int, default=25)
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in NAMES]
    if unknown:
        ap.error(f"unknown model(s) {unknown}; expected {list(NAMES)}")
    device = resolve_device(args.device)
    pt.pyplot()
    for name in args.names:
        data = trajectory(name, args.source, device)
        print("wrote", animate(name, data, args.out, args.fps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
