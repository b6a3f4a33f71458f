"""PPO over a trajectory lattice: a categorical policy picks a target
lateral offset, and a tracker turns it into controls.

Port of ``irbfn_tpu/train/ppo.py``:

- the envs are the batched ``TrackEnv`` (episodes as one batch);
- the discrete action picks a lattice offset; a proportional tracker with
  curvature feedforward converts it into (accel, steer-vel) for one control
  step;
- an update is rollout -> GAE -> clipped-surrogate epochs over shuffled
  minibatches, each step clipped by the global gradient norm then Adam
  (torch's Adam at optax's defaults). The rollout is a host loop over
  ``TrackEnv.step``.

Crashed envs are reset at the start of every update (episodes freeze when
they end, so without it the live pool would shrink). Every random draw
(start positions, actions, minibatch permutations) goes through
``PPOTrainer._draw`` on one ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from irbfn_tpu_torch.models.wcrbf import _dense_init
from irbfn_tpu_torch.sim.env import SimState, TrackEnv
from irbfn_tpu_torch.sim.map import linspace
from irbfn_tpu_torch.train.trainer import clip_by_global_norm_


class ActorCritic(nn.Module):
    """tanh MLP trunk with a logits head and a value head."""

    def __init__(self, n_actions: int, hidden: Sequence[int] = (64, 64),
                 in_features: int = 8, seed: int = 0, dtype=torch.float32,
                 device=None):
        super().__init__()
        widths = [in_features, *hidden]
        kw = dict(dtype=dtype, device=device)
        self.hidden = nn.ModuleList(nn.Linear(a, b, **kw)
                                    for a, b in zip(widths, widths[1:]))
        self.logits = nn.Linear(widths[-1], n_actions, **kw)
        self.value = nn.Linear(widths[-1], 1, **kw)
        # the JAX package's Dense defaults: LeCun-normal kernels, zero biases
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for layer in self.dense_layers():
                layer.weight.copy_(_dense_init(gen, layer.in_features,
                                               layer.out_features).T)
                layer.bias.zero_()

    def dense_layers(self) -> list:
        """The layers in the JAX module's order: Dense_0, Dense_1, ..."""
        return [*self.hidden, self.logits, self.value]

    def forward(self, obs):
        h = obs
        for layer in self.hidden:
            h = torch.tanh(layer(h))
        return self.logits(h), self.value(h)[..., 0]


@torch.no_grad()
def load_flax_params(model: ActorCritic, tree: dict) -> ActorCritic:
    """Copy a flax ``ActorCritic`` parameter tree (``{"params": {"Dense_i":
    {"kernel": (in, out), "bias": (out,)}}}`` or the inner dict) into
    ``model``: ``Dense_i.kernel`` becomes layer i's ``weight`` (out, in)."""
    tree = tree.get("params", tree)
    for i, layer in enumerate(model.dense_layers()):
        d = tree[f"Dense_{i}"]
        layer.weight.copy_(torch.as_tensor(np.array(d["kernel"])).T)
        layer.bias.copy_(torch.as_tensor(np.array(d["bias"])))
    return model


class PPOConfig(NamedTuple):
    n_envs: int = 64
    n_steps: int = 64
    n_epochs: int = 4
    n_minibatch: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    s0_spread: float = 50.0
    speed0: float = 2.0


def _obs_vector(obs):
    """Track-relative observation features (..., 8)."""
    return torch.stack([obs.ey, obs.epsi, obs.delta, obs.linear_vel_x,
                        obs.linear_vel_y, obs.ang_vel_z, obs.beta,
                        torch.sin(obs.pose_theta)], dim=-1)


def make_lattice_actions(n_lat: int = 7, max_ey_target: float = 1.0,
                         dtype=torch.float32, device=None):
    """The discrete action set: target lateral offsets across the
    lattice."""
    return linspace(-max_ey_target, max_ey_target, n_lat, dtype, device)


def _action_controls(obs, ey_target, track=None, wheelbase: float = 0.33,
                     v_target: float = 3.0):
    """Tracker toward the selected lattice offset: curvature feedforward
    and a steer-angle setpoint (a steering-rate law without feedforward
    limit-cycles on a closed track)."""
    if track is not None:
        delta_ff = torch.arctan(wheelbase * track.curvature_at(obs.s))
    else:
        delta_ff = torch.zeros_like(obs.ey)
    delta_des = torch.clamp(
        delta_ff - 0.35 * (obs.ey - ey_target) - 0.9 * obs.epsi, -0.4, 0.4)
    sv = torch.clamp(6.0 * (delta_des - obs.delta), -3.2, 3.2)
    a = torch.clamp(2.0 * (v_target - obs.linear_vel_x), -9.51, 9.51)
    return torch.stack([a, sv], dim=-1).to(obs.ey.dtype)


def _reward(obs, prev_s, new_s):
    """Progress along the raceline minus deviation penalties."""
    return (new_s - prev_s) - 0.5 * obs.ey.abs() - 0.2 * obs.epsi.abs()


def _gae(rewards, values, last_value, gamma: float, lam: float):
    """Generalised advantage estimates over (T, n_envs), backwards from
    ``last_value``."""
    advs = []
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next - values[t]
        adv_next = delta + gamma * lam * adv_next
        v_next = values[t]
        advs.append(adv_next)
    return torch.stack(advs[::-1])


def ppo_loss(net: ActorCritic, batch, cfg: PPOConfig):
    """The clipped-surrogate loss with value and entropy terms -> (loss,
    (pg_loss, v_loss, entropy))."""
    ov, action, logp_old, value_old, adv, ret = batch
    logits, value = net(ov)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, 1, action[:, None])[:, 0]
    ratio = torch.exp(logp - logp_old)
    # the population std (ddof 0), as jnp.std
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surrogate = torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n)
    pg_loss = -surrogate.mean()
    v_loss = torch.mean((value - ret) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss, (pg_loss, v_loss, entropy)


class PPOTrainer:
    def __init__(self, env: TrackEnv, cfg: PPOConfig = PPOConfig(),
                 n_lattice: int = 7, seed: int = 0):
        self.env = env
        self.cfg = cfg
        dtype, device = env.params.dtype, env.params.dt.device
        self.device = device
        self.offsets = make_lattice_actions(n_lattice, dtype=dtype,
                                            device=device)
        self.net = ActorCritic(n_actions=n_lattice, seed=seed, device=device)
        self.params = list(self.net.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.gen = torch.Generator(device=device).manual_seed(int(seed))

    def _draw(self, kind: str, arg):
        """Every random draw of training: ``"s0"`` -> (n_envs,) start arc
        lengths in [0, s0_spread); ``"action"`` -> one categorical action
        per row of the logits ``arg``; ``"perm"`` -> a permutation of
        ``range(arg)``."""
        cfg, g, dev = self.cfg, self.gen, self.device
        if kind == "s0":
            return torch.rand(cfg.n_envs, generator=g, device=dev,
                              dtype=self.offsets.dtype) * cfg.s0_spread
        if kind == "action":
            return torch.multinomial(torch.softmax(arg, dim=-1), 1,
                                     generator=g)[:, 0]
        if kind == "perm":
            return torch.randperm(arg, generator=g, device=dev)
        raise ValueError(f"unknown draw {kind!r}")

    def _reset(self) -> SimState:
        cfg = self.cfg
        return self.env.reset(s0=self._draw("s0", None), speed0=cfg.speed0,
                              batch_shape=(cfg.n_envs,))

    @torch.no_grad()
    def _rollout(self, sim: SimState):
        env, net, cfg = self.env, self.net, self.cfg
        traj = []
        for _ in range(cfg.n_steps):
            obs = env.observe(sim)
            ov = _obs_vector(obs)
            logits, value = net(ov)
            action = self._draw("action", logits)
            logp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                                action[:, None])[:, 0]
            controls = _action_controls(obs, self.offsets[action],
                                        track=env.track)
            sim_next = env.step(sim, controls)
            reward = _reward(obs, sim.s, sim_next.s)
            traj.append((ov, action, logp, value, reward))
            sim = sim_next
        _, last_value = net(_obs_vector(env.observe(sim)))
        return sim, [torch.stack(a) for a in zip(*traj)], last_value

    def update(self, sim: SimState):
        """One PPO update from ``sim``: reset the crashed envs, roll out,
        GAE, then n_epochs x n_minibatch steps. Returns (sim, metrics)."""
        cfg = self.cfg
        crashed = sim.done
        fresh = self._reset()
        sim = SimState(*[torch.where(
            crashed.reshape(crashed.shape + (1,) * (o.ndim - crashed.ndim)),
            f, o) for f, o in zip(fresh, sim)])
        sim, (ov, action, logp, value, reward), last_value = \
            self._rollout(sim)
        adv = _gae(reward, value, last_value, cfg.gamma, cfg.gae_lambda)
        ret = adv + value
        data = tuple(a.reshape((-1,) + a.shape[2:])
                     for a in (ov, action, logp, value, adv, ret))
        n = data[0].shape[0]
        mb = n // cfg.n_minibatch
        epoch_losses = []
        for _ in range(cfg.n_epochs):
            perm = self._draw("perm", n)
            losses = []
            for i in range(cfg.n_minibatch):
                idx = perm[i * mb:(i + 1) * mb]
                loss, _ = ppo_loss(self.net, tuple(a[idx] for a in data),
                                   cfg)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_(self.params, cfg.max_grad_norm)
                self.optimizer.step()
                losses.append(loss.detach())
            epoch_losses.append(torch.stack(losses).mean())
        metrics = {"loss": torch.stack(epoch_losses).mean(),
                   "reward": reward.mean(), "mean_progress": sim.s.mean(),
                   "crash_rate": crashed.to(reward.dtype).mean()}
        return sim, metrics

    def train(self, n_updates: int = 10):
        """``n_updates`` updates from fresh starts; returns the history of
        per-update metrics as floats."""
        sim = self._reset()
        history = []
        for _ in range(n_updates):
            sim, metrics = self.update(sim)
            history.append({k: float(v) for k, v in metrics.items()})
        return history


__all__ = ["ActorCritic", "PPOConfig", "PPOTrainer", "load_flax_params",
           "make_lattice_actions", "ppo_loss"]
