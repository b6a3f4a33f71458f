"""Figures of episodes: the raceline, a goal, predicted rollouts, driven
trajectories, an occupancy map, and an episode as an animated GIF.

Port of ``irbfn_tpu/sim/render.py``. matplotlib (and Pillow, for the GIF)
are imported inside the functions that need them, never when the module is
imported: a machine without them runs everything else. Tensors on any
device are copied to the host before drawing.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def draw_track(ax, track, color="0.6", show_heading_ticks: bool = False):
    rl = track.raceline
    xs, ys = _np(rl.xs), _np(rl.ys)
    ax.plot(np.append(xs, xs[0]), np.append(ys, ys[0]), color=color, lw=1,
            label="raceline")
    if show_heading_ticks:
        yaws = _np(rl.yaws)
        step = max(1, len(xs) // 40)
        ax.quiver(xs[::step], ys[::step], np.cos(yaws[::step]),
                  np.sin(yaws[::step]), scale=40, width=2e-3, color=color)
    ax.set_aspect("equal")


def draw_goal(ax, goal_xy, color="tab:green"):
    ax.plot([float(goal_xy[0])], [float(goal_xy[1])], "o", ms=6, color=color,
            label="goal")


def draw_plan(ax, states_xy, color="tab:blue", label="plan"):
    """Predicted rollout(s): (T, 2) or (B, T, 2)."""
    arr = _np(states_xy)
    if arr.ndim == 2:
        arr = arr[None]
    for i, traj in enumerate(arr):
        ax.plot(traj[:, 0], traj[:, 1], "-", lw=1.5, color=color,
                label=label if i == 0 else None)


def _poses(obs_traj, stride: int = 1):
    """(x, y) of stacked Observations or a StepRecord trajectory, each of
    shape (T, B)."""
    obs_traj = getattr(obs_traj, "obs", obs_traj)
    xs = _np(obs_traj.pose_x)[::stride]
    ys = _np(obs_traj.pose_y)[::stride]
    if xs.ndim == 1:
        xs, ys = xs[:, None], ys[:, None]
    return xs, ys


def draw_trajectory(ax, obs_traj, color="tab:red", label="driven"):
    """A driven closed-loop trajectory: stacked Observations or a
    StepRecord trajectory, shape (T,) or (T, B)."""
    xs, ys = _poses(obs_traj)
    for b in range(xs.shape[1]):
        ax.plot(xs[:, b], ys[:, b], "-", lw=1, color=color, alpha=0.7,
                label=label if b == 0 else None)


def animate_episode(track, obs_traj, path, fps: int = 20,
                    trail: int = 60, stride: int = 1, occ_map=None,
                    figsize=(7, 5)):
    """Render a closed-loop episode to an animated GIF (matplotlib and
    Pillow).

    ``obs_traj``: stacked Observations or a StepRecord trajectory, shapes
    (T,) or (T, B); every episode of a batch is drawn. ``trail``: past
    steps kept visible behind each car. ``occ_map``: an occupancy map drawn
    under the track."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    xs, ys = _poses(obs_traj, stride)
    T, B = xs.shape
    fig, ax = plt.subplots(figsize=figsize)
    if occ_map is not None:
        draw_map(ax, occ_map)
    draw_track(ax, track)
    trails = [ax.plot([], [], "-", lw=1, color="tab:red", alpha=0.7)[0]
              for _ in range(B)]
    dots = [ax.plot([], [], "o", ms=4, color="tab:red")[0]
            for _ in range(B)]
    ax.set_xlim(np.nanmin(xs) - 2, np.nanmax(xs) + 2)
    ax.set_ylim(np.nanmin(ys) - 2, np.nanmax(ys) + 2)

    def update(t):
        lo = max(0, t - trail)
        for b in range(B):
            trails[b].set_data(xs[lo:t + 1, b], ys[lo:t + 1, b])
            dots[b].set_data(xs[t:t + 1, b], ys[t:t + 1, b])
        return trails + dots

    anim = manim.FuncAnimation(fig, update, frames=T, blit=True)
    anim.save(path, writer=manim.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def draw_map(ax, occ_map, free_color="1.0", occ_color="0.3"):
    """Draw an OccupancyMap (free against obstacle) in world coordinates
    under the other artists (axis-aligned maps)."""
    import matplotlib.colors as mcolors

    dist = _np(occ_map.dist)
    h, w = dist.shape
    res = float(occ_map.resolution)
    ox, oy = float(occ_map.origin_x), float(occ_map.origin_y)
    cmap = mcolors.ListedColormap([occ_color, free_color])
    ax.imshow((dist > 0).astype(np.uint8), origin="lower", cmap=cmap,
              extent=(ox, ox + w * res, oy, oy + h * res), zorder=-1,
              interpolation="nearest")


def plot_episode(track, obs_traj, plan_xy=None, goal_xy=None, path=None):
    """One-call episode figure; saved to ``path`` if given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    draw_track(ax, track)
    draw_trajectory(ax, obs_traj)
    if plan_xy is not None:
        draw_plan(ax, plan_xy)
    if goal_xy is not None:
        draw_goal(ax, goal_xy)
    ax.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path)
    return fig, ax


__all__ = ["animate_episode", "draw_goal", "draw_map", "draw_plan",
           "draw_track", "draw_trajectory", "plot_episode"]
