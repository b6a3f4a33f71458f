"""Online effective-grip estimation from one-step lateral residuals.

Port of ``irbfn_tpu/planning/grip.py``. In the sim's dynamic single-track
model every lateral-force term carries ``mu * C_S`` linearly, so with
``C_Sf = C_Sr`` the yaw and slip accelerations decompose exactly as

    [psi_ddot, beta_dot](g) = g * tire(x, u) + base(x),   g = mu*cs / (mu0*cs0)

where ``tire = deriv(p0) - deriv(p0 with mu = 0)`` and ``base = deriv(mu =
0)`` both come from the nominal params ``p0``. One scalar ``g`` captures both
unknowns the robustness sweeps vary.

The estimator is a gated per-step least squares on that scalar: measure
``[d psi_dot, d beta] / dt`` across a control period, subtract ``base``,
project onto ``tire``, and take an exponential moving average of the
quotient. Gates: a previous sample, a speed above the sim's kinematic blend
(below it the stepped model has no tire forces) and a tire prediction large
enough to divide by. The average revises grip down faster than up: an
overestimate costs a spin, an underestimate only pace.

``GripAdaptiveFrenetPlanner`` (``planner.py``) picks the nearest-mu arm of a
net bank and the pace scale sqrt(g) from this estimate, per episode lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from irbfn_tpu_torch._device import resolve_device
from irbfn_tpu_torch.dynamics.params import VehicleParams
from irbfn_tpu_torch.dynamics.single_track import V_BLEND, st_deriv

# lateral rows of the single-track state derivative: psi_ddot, beta_dot
_LAT = slice(5, 7)


class GripConfig(NamedTuple):
    """Observer gains. ``w_beta`` rescales the beta_dot row into psi_ddot
    units (beta_dot magnitudes are ~wheelbase/v smaller), so that the
    projection is not dominated by one row."""

    g0: float = 0.5          # conservative prior (pace sqrt(g0) ~ 0.71)
    beta_up: float = 0.10    # averaging rate when revising grip up
    beta_down: float = 0.35  # averaging rate when revising grip down
    exc_min: float = 0.5     # min weighted |tire| [rad/s^2] to update
    v_min: float = V_BLEND + 0.5  # below the kinematic blend: no information
    g_lo: float = 0.05
    g_hi: float = 2.5
    w_beta: float = 4.0


class GripState(NamedTuple):
    """Per-lane observer carry (every field batched over the lanes)."""

    g: torch.Tensor          # (...,) effective lateral gain estimate
    prev_lat: torch.Tensor   # (..., 2) previous [psi_dot, beta]
    prev_tire: torch.Tensor  # (..., 2) tire-term prediction recorded then
    prev_base: torch.Tensor  # (..., 2) mu = 0 baseline recorded then
    has_prev: torch.Tensor   # (...,) bool


def grip_init(batch_shape, cfg: GripConfig = GripConfig(),
              dtype=torch.float32, device=None) -> GripState:
    """The prior state of ``batch_shape`` lanes, on ``device`` (None: the
    card)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    batch_shape = tuple(batch_shape)
    return GripState(
        g=torch.full(batch_shape, cfg.g0, **kw),
        prev_lat=torch.zeros(batch_shape + (2,), **kw),
        prev_tire=torch.zeros(batch_shape + (2,), **kw),
        prev_base=torch.zeros(batch_shape + (2,), **kw),
        has_prev=torch.zeros(batch_shape, dtype=torch.bool,
                             device=kw["device"]))


def _cart_state(obs) -> torch.Tensor:
    """The sim's 7-dim single-track state rebuilt from an Observation
    (``TrackEnv.observe`` is a bijection on these fields)."""
    return torch.stack([obs.pose_x, obs.pose_y, obs.delta, obs.linear_vel_x,
                        obs.pose_theta, obs.ang_vel_z, obs.beta], dim=-1)


def grip_update(state: GripState, obs, cfg: GripConfig,
                ctrl_dt: float) -> GripState:
    """Fold the newly observed lateral state into the gain estimate. Call it
    at the top of the policy, before choosing the action: it compares the
    lateral change over the last control period with the predictions that
    ``grip_record`` stored when that action was issued."""
    lat = torch.stack([obs.ang_vel_z, obs.beta], dim=-1)
    w = torch.tensor([1.0, cfg.w_beta], dtype=lat.dtype, device=lat.device)
    measured = (lat - state.prev_lat) / ctrl_dt
    resid = (measured - state.prev_base) * w
    tire = state.prev_tire * w
    tt = torch.sum(tire * tire, dim=-1)
    g_inst = torch.sum(tire * resid, dim=-1) / torch.clamp(tt, min=1e-12)
    g_inst = torch.clamp(g_inst, cfg.g_lo, cfg.g_hi)
    gate = (state.has_prev & (torch.sqrt(tt) >= cfg.exc_min)
            & (obs.linear_vel_x >= cfg.v_min))
    beta = torch.where(g_inst < state.g,
                       torch.full_like(g_inst, cfg.beta_down),
                       torch.full_like(g_inst, cfg.beta_up))
    g_new = torch.where(gate, (1.0 - beta) * state.g + beta * g_inst,
                        state.g)
    return state._replace(g=g_new.to(state.g.dtype))


def grip_record(state: GripState, obs, action: torch.Tensor,
                p_nominal: VehicleParams, cfg: GripConfig) -> GripState:
    """Record this step's tire and base predictions for the next update.
    Call it at the bottom of the policy with the action about to be applied.
    ``p_nominal`` defines the g = 1 reference (e.g. the f1tenth params at
    mu = 1, C_S = 5, the bank's training nominal)."""
    del cfg  # the record needs no gain; kept for the reference's signature
    x = _cart_state(obs)
    d_nom = st_deriv(x, action, p_nominal)
    d_base = st_deriv(x, action, p_nominal.replace(
        mu=torch.zeros_like(p_nominal.mu)))
    lat = torch.stack([obs.ang_vel_z, obs.beta], dim=-1)
    dt = state.prev_lat.dtype
    return state._replace(
        prev_lat=lat.to(dt),
        prev_tire=(d_nom[..., _LAT] - d_base[..., _LAT]).to(dt),
        prev_base=d_base[..., _LAT].to(dt),
        has_prev=torch.ones_like(state.has_prev))
