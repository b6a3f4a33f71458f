"""EXP3 adversarial bandit for online model/table selection.

Port of ``irbfn_tpu/planning/bandits.py``: arm weights with exponential
updates, gamma-mixed sampling, sigmoid reward squashing, used by the
adaptive planners to pick among models trained for different (mu, cs)
dynamics. The state functions are pure; a small stateful wrapper mirrors the
reference object API. The bandit lives on the host (a handful of floats per
episode). Arms are drawn as the JAX package draws them, ``choice(key, n,
p=probs)`` in f32 from a key split off ``PRNGKey(seed)`` for each pull
(``utils/prng.py``), so one seed gives the JAX package's arms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from irbfn_tpu_torch.utils import prng


class EXP3State(NamedTuple):
    weights: torch.Tensor  # (n_arms,)
    gamma: torch.Tensor  # exploration rate (scalar)
    last_probs: torch.Tensor  # sampling distribution of the latest pull


def exp3_init(n_arms: int, gamma: float, dtype=torch.float32) -> EXP3State:
    return EXP3State(torch.ones(n_arms, dtype=dtype),
                     torch.tensor(gamma, dtype=dtype),
                     torch.full((n_arms,), 1.0 / n_arms, dtype=dtype))


def exp3_probs(state: EXP3State) -> torch.Tensor:
    n = state.weights.shape[0]
    return ((1.0 - state.gamma) * state.weights / state.weights.sum()
            + state.gamma / n)


def exp3_pull(state: EXP3State, key) -> tuple:
    """Draw an arm from the gamma-mixed distribution with ``key`` (a
    ``utils/prng.py`` key): JAX's ``choice(key, n, p=probs)``."""
    probs = exp3_probs(state)
    arm = int(prng.choice(key, probs.shape[0], probs))
    return arm, state._replace(last_probs=probs)


def exp3_update(state: EXP3State, arm, reward,
                rew_scale: Optional[float] = 0.5) -> EXP3State:
    """Exponential weight update.

    ``rew_scale`` selects the reward map. The reference squashes through
    ``sigmoid(rew_scale * r)`` so that unbounded scores land in (0, 1); kept
    as the default for parity. But for rewards ALREADY normalized to [0, 1]
    (e.g. lap-progress fractions) the sigmoid maps the whole range into
    [0.5, 0.62]: a 0.5 reward gap shrinks to ~0.06 and the weights never
    separate (40-episode runs stay within noise of uniform pulls). Pass
    ``rew_scale=None`` to use the raw [0, 1] reward, the standard EXP3
    estimator with its regret guarantee intact.
    """
    n = state.weights.shape[0]
    reward = torch.as_tensor(reward, dtype=state.weights.dtype)
    if rew_scale is None:
        r = torch.clamp(reward, 0.0, 1.0)
    else:
        r = torch.sigmoid(torch.clamp(rew_scale * reward, -100.0, 100.0))
    adj = torch.where(torch.arange(n) == int(arm),
                      r / state.last_probs[int(arm)],
                      torch.zeros((), dtype=r.dtype))
    weights = state.weights * torch.exp(state.gamma * adj / n)
    # renormalize to keep the weights bounded over long runs (pure scaling:
    # exp3_probs is invariant to it)
    weights = weights / weights.max()
    return state._replace(weights=weights)


class EXP3:
    """Stateful wrapper with the reference's object API."""

    def __init__(self, n: int, gamma: float, seed: int = 0):
        self.n = n
        self.gamma = gamma
        self._key = prng.PRNGKey(seed)
        self.state = exp3_init(n, gamma)

    def reset(self):
        self.state = exp3_init(self.n, self.gamma)

    @property
    def weights(self):
        return self.state.weights.numpy()

    def pull_arm(self) -> int:
        self._key, sub = prng.split(self._key)
        arm, self.state = exp3_pull(self.state, sub)
        return arm

    def update_dist(self, i: int, r: float,
                    rew_scale: Optional[float] = 0.5):
        self.state = exp3_update(self.state, i, r, rew_scale)
