"""The trajectory, animation and distribution scripts of the port
(`ipddp2tpu_torch/experiments/{plot_trajectories,animate,plot_distributions}.py`)
on the CPU, with matplotlib's Agg backend.

- `trajectories` of concar at T = 16 (B = 1): converged, finite, its
  arrays saved and read back, and `draw` from the `.npz` writes a PNG.
- `animate.frame` draws one frame of each model, and `animate` writes a GIF
  of a three-frame trajectory.
- `plot_distributions.summary` on a results table of five rows in the
  format `run_benchmarks` writes: solved counts and medians as counted by
  hand; the JAX column from the committed table; the boxplots' PNG.
"""

import types

import numpy as np
import pytest
import torch

from ipddp2tpu_torch.experiments import animate
from ipddp2tpu_torch.experiments import plot_distributions as pd
from ipddp2tpu_torch.experiments import plot_trajectories as pt
from ipddp2tpu_torch.experiments import run_benchmarks

torch.set_num_threads(1)


def test_trajectories_saved_and_drawn(tmp_path):
    data = pt.trajectories("concar", "cpu", T=16)
    assert data["x"].shape == (17, 4) and data["u"].shape == (16, 10)
    assert bool(data["converged"]) and int(data["status"]) == 0
    assert np.isfinite(data["x"]).all() and np.isfinite(data["u"]).all()
    assert data["theta_obstacles"].shape == (4, 3)
    path = pt.save(data, tmp_path)
    assert path.name == "concar_seed1.npz"
    back = pt.load(path)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v)
    png = pt.draw("concar", path, tmp_path)
    assert png.name == "concar_seed1.png" and png.stat().st_size > 0


def _pendulum_data(T=3):
    rng = np.random.default_rng(0)
    return dict(x=rng.standard_normal((T + 1, 4)),
                theta_l=np.array(0.5), theta_l1=np.array(1.0),
                theta_l2=np.array(0.9))


def test_animation_frames_and_gif(tmp_path):
    plt = pt.pyplot()
    fig, ax = plt.subplots()
    data = _pendulum_data()
    cart, pole = animate.frame("cartpole", data, 2, ax)
    cx, th = data["x"][2, 2:4]
    np.testing.assert_allclose(pole.get_xdata(), [cx, cx + 0.5 * np.sin(th)])
    links, = animate.frame("acrobot", data, 1, ax)
    assert len(links.get_xdata()) == 3
    concar = dict(x=np.linspace(0, 1, 20).reshape(5, 4),
                  theta_obstacles=np.array([[0.5, 0.5, 0.1]]))
    trail, car, nose = animate.frame("concar", concar, 3, ax)
    assert len(trail.get_xdata()) == 4
    plt.close(fig)
    gif = animate.animate("acrobot", data, tmp_path, fps=5)
    assert gif.name == "acrobot_contact_seed1.gif" and gif.stat().st_size > 0


def test_distributions_summary_and_png(tmp_path):
    """Five rows: seeds 1, 2, 4, 5 solved in 10, 30, 20, 40 iterations to
    objectives 1, 3, 2, 4; seed 3 unsolved (iterations 999, objective 9,
    left out of the quartiles)."""
    ok = torch.tensor([True, True, False, True, True])
    sol = types.SimpleNamespace(
        converged=ok, status=torch.where(ok, 0, 7),
        iterations=torch.tensor([10, 30, 999, 20, 40]),
        objective=torch.tensor([1.0, 3.0, 9.0, 2.0, 4.0],
                               dtype=torch.float64),
        primal_inf=torch.zeros(5, dtype=torch.float64))
    (tmp_path / "concar.txt").write_text(run_benchmarks.results_table(sol, 5))
    s = pd.summary("concar", ours=tmp_path)
    ours = s["ipddp2tpu_torch"]
    assert (ours["solved"], ours["total"]) == (4, 5)
    assert ours["iterations"] == (17.5, 25.0, 32.5)
    assert ours["objective"] == (1.75, 2.5, 3.25)
    jax_rows = (run_benchmarks.RESULTS / "concar.txt").read_text() \
        .splitlines()[1:]
    jax = s["ipddp2tpu (JAX)"]
    assert jax["total"] == len([r for r in jax_rows if r.strip()])
    assert jax["solved"] == sum(" true " in r for r in jax_rows)
    png = pd.plot("concar", ours=tmp_path, out=tmp_path)
    assert png.name == "dist_concar.png" and png.stat().st_size > 0
    with pytest.raises(SystemExit):
        pd.main(["no_such_problem", "--device", "cpu", "--no-draw"])
