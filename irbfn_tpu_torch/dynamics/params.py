"""Vehicle parameters as a tensor dataclass.

Port of ``irbfn_tpu/dynamics/params.py``. Every field is a tensor: a 0-dim
tensor for one vehicle, or a ``(B,)`` tensor to give each lane of a batched
rollout its own value (a (mu, cs) sweep is one batch axis). The field order
is the reference's 13-float parameter vector
``[mu, m, I, lf, lr, C_Sf, C_Sr, h, dt, sv_max, a_max, s_max, v_max]``.
``f1tenth_params`` and ``fullscale_params`` put their tensors on ``device``
(None: the card).
"""

from __future__ import annotations

import dataclasses

import torch

from irbfn_tpu_torch._device import resolve_device

G = 9.81


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Single-track vehicle parameters (CommonRoad conventions)."""

    mu: torch.Tensor  # friction coefficient
    m: torch.Tensor  # mass [kg]
    I: torch.Tensor  # yaw moment of inertia [kg m^2]
    lf: torch.Tensor  # CoG -> front axle [m]
    lr: torch.Tensor  # CoG -> rear axle [m]
    C_Sf: torch.Tensor  # front cornering stiffness
    C_Sr: torch.Tensor  # rear cornering stiffness
    h: torch.Tensor  # CoG height [m]
    dt: torch.Tensor  # integration timestep [s]
    sv_max: torch.Tensor  # max steering velocity [rad/s]
    a_max: torch.Tensor  # max acceleration [m/s^2]
    s_max: torch.Tensor  # max steering angle [rad]
    v_max: torch.Tensor  # max velocity [m/s]

    @property
    def wheelbase(self):
        return self.lf + self.lr

    @property
    def dtype(self) -> torch.dtype:
        return self.dt.dtype

    @classmethod
    def from_vector(cls, vec) -> "VehicleParams":
        """Build from the reference's 13-float parameter vector layout."""
        vec = torch.as_tensor(vec)
        return cls(*[vec[..., i] for i in range(13)])

    def to_vector(self) -> torch.Tensor:
        return torch.stack(torch.broadcast_tensors(*self.fields()), dim=-1)

    def fields(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def to(self, device=None, dtype=None) -> "VehicleParams":
        return VehicleParams(*[torch.as_tensor(f).to(device=device,
                                                     dtype=dtype)
                               for f in self.fields()])

    def replace(self, **changes) -> "VehicleParams":
        return dataclasses.replace(self, **changes)


def _make(vals, dtype, device) -> VehicleParams:
    device = resolve_device(device)
    return VehicleParams(*[torch.as_tensor(v, dtype=dtype, device=device)
                           for v in vals])


def f1tenth_params(mu: float = 1.0, cs: float = 5.0, dt: float = 0.1,
                   dtype=torch.float32, device=None) -> VehicleParams:
    """F1TENTH-scale car, the constants of the reference planners."""
    return _make([mu, 1.0489, 0.04712, 0.15875, 0.17145, cs, cs, 0.074, dt,
                  3.2, 9.51, 0.4189, 7.0], dtype, device)


def fullscale_params(mu: float = 1.0, cs: float = 5.0, dt: float = 0.1,
                     dtype=torch.float32, device=None) -> VehicleParams:
    """Heavier vehicle used by the Frenet NMPC oracle."""
    return _make([mu, 15.32, 0.64332, 0.2735, 0.2585, cs, cs, 0.1875, dt,
                  3.141592653589793, 9.51, 0.4189, 10.0], dtype, device)
