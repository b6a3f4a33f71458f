"""The port's figures (``irbfn_tpu_torch/sim/render.py``): each function
draws, an episode renders to a PNG and to an animated GIF (the checks of
``tests/test_render_and_csv.py``), and the simulator package imports no
matplotlib (a machine without it runs everything but the figures)."""

import os
import subprocess
import sys

import numpy as np
import torch

from irbfn_tpu_torch.dynamics.params import f1tenth_params
from irbfn_tpu_torch.sim import TrackEnv, oval_track, rasterize_track
from irbfn_tpu_torch.sim import render

torch.set_num_threads(1)


def _episode(batch=(), steps=10):
    track = oval_track(n_samples=128, device="cpu")
    env = TrackEnv(track, f1tenth_params(dt=0.1, device="cpu"))
    sim = env.reset(s0=0.0, speed0=2.0, batch_shape=batch)
    _, traj = env.rollout(sim, lambda o: torch.zeros(o.ey.shape + (2,)),
                          steps)
    return track, traj


def test_torch_plot_episode_renders(tmp_path):
    track, traj = _episode()
    out = str(tmp_path / "ep.png")
    fig, ax = render.plot_episode(track, traj, plan_xy=np.zeros((5, 2)),
                                  goal_xy=(5.0, 0.0), path=out)
    assert os.path.getsize(out) > 1000
    labels = {t.get_text() for t in ax.get_legend().get_texts()}
    assert {"raceline", "driven", "plan", "goal"} <= labels


def test_torch_animate_episode_writes_gif(tmp_path):
    track, traj = _episode(batch=(2,), steps=8)
    omap = rasterize_track(track, half_width=2.0, resolution=0.2)
    out = tmp_path / "ep.gif"
    render.animate_episode(track, traj, str(out), fps=5, occ_map=omap)
    assert out.exists() and out.stat().st_size > 2000


def test_torch_draw_helpers(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    track, traj = _episode(batch=(3,))
    fig, ax = plt.subplots()
    render.draw_map(ax, rasterize_track(track, half_width=2.0,
                                        resolution=0.2))
    render.draw_track(ax, track, show_heading_ticks=True)
    render.draw_trajectory(ax, traj)
    render.draw_plan(ax, torch.zeros(4, 6, 2))
    assert len(ax.lines) == 1 + 3 + 4 and len(ax.images) == 1
    fig.savefig(tmp_path / "helpers.png")
    plt.close(fig)


def test_torch_sim_package_imports_no_matplotlib():
    code = ("import sys; import irbfn_tpu_torch.sim; "
            "import irbfn_tpu_torch.sim.render; "
            "sys.exit(int('matplotlib' in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
