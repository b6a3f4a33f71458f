"""PyTorch port of PPO over the trajectory lattice (``train/ppo.py``) vs the
JAX package.

- The observation features, the tracker's controls and the reward on the
  same observations, f32, to 1e-6 relative and 5e-6 absolute (the f32 last
  place of controls up to 9.51; values derived from the f32 raceline's
  curvature agree to its last place).
- ``ActorCritic`` with parameters carried over from a flax init: f32, 1e-6.
- GAE against the JAX update's backward recursion; the clipped-surrogate
  loss and its gradient against ``jax.value_and_grad`` of the JAX update's
  loss (advantages normalised by the population std, ddof 0): f32, 1e-5
  relative.
- One whole update from the JAX side's initial parameters and with the JAX
  side's draws (start positions, actions, permutations), stored by
  ``scripts/export_torch_ckpt.py --ppo_golden``: at the JAX test's size
  (16 envs x 16 steps, 5 actions, 2 epochs x 2 minibatches) every
  parameter tensor to 1e-4 relative (its norm) and the metrics to 1e-4; at
  ``train_ppo``'s widths (64 x 64, 7 actions, 4 x 4) to 1e-3
  (``TOL_UPDATE_FULL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.sim import oval_track as joval_track
from irbfn_tpu.sim.env import Observation as JObservation
from irbfn_tpu.train import ppo as JP
from irbfn_tpu_torch.sim import oval_track
from irbfn_tpu_torch.sim.env import Observation
from irbfn_tpu_torch.train import ppo as PP
from irbfn_tpu_torch.train import train_ppo
from irbfn_tpu_torch.train.checkpoints import unflatten_tree

torch.set_num_threads(1)
GOLDEN = "irbfn_tpu_torch/assets/ppo_golden.npz"
TOL = dict(rtol=1e-6, atol=5e-6)
TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
TOL_UPDATE = 1e-4
# at train_ppo's widths the 64-step rollout of 64 envs already differs by
# ~1.5e-4 relative in the reward (f32 dynamics, a last place per substep),
# and the normalised advantages carry it into every step
TOL_UPDATE_FULL = 1e-3
DRAW = {"s0": "uniform", "action": "categorical", "perm": "permutation"}


def _obs(rng, n, track_length):
    f = {k: rng.normal(0, 0.3, n).astype(np.float32)
         for k in Observation._fields if k != "scan"}
    f["s"] = rng.uniform(0, track_length, n).astype(np.float32)
    f["linear_vel_x"] = rng.uniform(0.5, 5.0, n).astype(np.float32)
    return f


def test_torch_ppo_features_controls_reward_match_jax():
    jt = joval_track(n_samples=256, speed=3.0)
    pt = oval_track(n_samples=256, speed=3.0, device="cpu")
    f = _obs(np.random.default_rng(0), 64, float(pt.raceline.length))
    oj = JObservation(**{k: jnp.asarray(v) for k, v in f.items()})
    ot = Observation(**{k: torch.as_tensor(v) for k, v in f.items()})
    np.testing.assert_allclose(PP._obs_vector(ot).numpy(),
                               np.asarray(JP._obs_vector(oj)), **TOL)
    with jax.enable_x64(False):
        offs_j = np.asarray(JP.make_lattice_actions(7))
    offs = PP.make_lattice_actions(7, device="cpu")
    np.testing.assert_allclose(offs.numpy(), offs_j, **TOL)
    target = np.random.default_rng(1).choice(offs_j, 64)
    for tj, tt in ((jt, pt), (None, None)):
        np.testing.assert_allclose(
            PP._action_controls(ot, torch.as_tensor(target), track=tt
                                ).numpy(),
            np.asarray(JP._action_controls(oj, jnp.asarray(target),
                                           track=tj)), **TOL)
    new_s = f["s"] + 0.3
    np.testing.assert_allclose(
        PP._reward(ot, ot.s, torch.as_tensor(new_s)).numpy(),
        np.asarray(JP._reward(oj, oj.s, jnp.asarray(new_s))), **TOL)


@pytest.fixture(scope="module")
def flax_net():
    with jax.enable_x64(False):
        net = JP.ActorCritic(n_actions=7)
        params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, 8)))
    return net, jax.tree.map(np.asarray, params)


def test_torch_actor_critic_matches_flax(flax_net):
    net, params = flax_net
    x = np.random.default_rng(2).normal(size=(32, 8)).astype(np.float32)
    with jax.enable_x64(False):
        lj, vj = net.apply(params, jnp.asarray(x))
    model = PP.load_flax_params(PP.ActorCritic(7), params)
    with torch.no_grad():
        lt, vt = model(torch.as_tensor(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    # the port's own seeded init draws the JAX layout's shapes
    fresh = PP.ActorCritic(7, seed=0)
    for i, layer in enumerate(fresh.dense_layers()):
        assert layer.weight.T.shape == params["params"][f"Dense_{i}"][
            "kernel"].shape


def _jax_gae(r, v, last, gamma, lam):
    """The JAX update's recursion, backwards from ``last``."""
    adv_next, v_next, out = np.zeros_like(last), last, []
    for t in range(r.shape[0] - 1, -1, -1):
        adv_next = r[t] + gamma * v_next - v[t] + gamma * lam * adv_next
        v_next = v[t]
        out.append(adv_next)
    return np.stack(out[::-1])


def _jax_loss(net, cfg):
    """The JAX update's loss (``irbfn_tpu/train/ppo.py``), on a batch."""
    def loss_fn(params, batch):
        ov, action, logp_old, value_old, adv, ret = batch
        logits, value = net.apply(params, ov)
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(logp_all, action[:, None], 1).squeeze(1)
        ratio = jnp.exp(logp - logp_old)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
        surrogate = jnp.minimum(
            ratio * adv_n,
            jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n)
        pg_loss = -surrogate.mean()
        v_loss = jnp.mean((value - ret) ** 2)
        entropy = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
        return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss_fn


def test_torch_ppo_gae_loss_and_gradient_match_jax(flax_net):
    net, params = flax_net
    rng = np.random.default_rng(4)
    T, n = 12, 16
    r = rng.normal(size=(T, n)).astype(np.float32)
    v = rng.normal(size=(T, n)).astype(np.float32)
    last = rng.normal(size=n).astype(np.float32)
    cfg = PP.PPOConfig()
    adv = PP._gae(torch.as_tensor(r), torch.as_tensor(v),
                  torch.as_tensor(last), cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(adv.numpy(), _jax_gae(r, v, last, cfg.gamma,
                                                     cfg.gae_lambda),
                               **TOL_LOSS)
    B = T * n
    batch = (rng.normal(size=(B, 8)).astype(np.float32),
             rng.integers(0, 7, B), rng.normal(-1.9, 0.3, B).astype(
                 np.float32), v.reshape(-1), adv.numpy().reshape(-1),
             rng.normal(size=B).astype(np.float32))
    with jax.enable_x64(False):
        lj, gj = jax.value_and_grad(_jax_loss(net, cfg))(
            params, tuple(jnp.asarray(a) for a in batch))
    model = PP.load_flax_params(PP.ActorCritic(7), params)
    loss, _ = PP.ppo_loss(model, tuple(torch.as_tensor(a) for a in batch),
                          cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), **TOL_LOSS)
    for i, layer in enumerate(model.dense_layers()):
        g = gj["params"][f"Dense_{i}"]
        scale = max(1.0, float(np.abs(g["kernel"]).max()))
        np.testing.assert_allclose(layer.weight.grad.T.numpy(),
                                   np.asarray(g["kernel"]), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(layer.bias.grad.numpy(),
                                   np.asarray(g["bias"]), rtol=0,
                                   atol=1e-5 * scale)


def replay(golden, prefix=""):
    """A ``PPOTrainer._draw`` that hands out the JAX side's draws in order;
    it checks that each is of the kind the port asks for."""
    kinds = list(golden[prefix + "draw_kinds"])
    queue = [golden[f"{prefix}draw_{i}"] for i in range(len(kinds))]

    def draw(kind, arg):
        assert kinds.pop(0) == DRAW[kind]
        v = torch.as_tensor(queue.pop(0))
        return v.to(torch.float32 if kind == "s0" else torch.int64)

    return draw


@pytest.mark.parametrize("prefix,cfg,n_lattice,tol", [
    ("small_", dict(n_envs=16, n_steps=16, n_epochs=2, n_minibatch=2), 5,
     TOL_UPDATE),
    ("", {}, 7, TOL_UPDATE_FULL)])
def test_torch_ppo_update_matches_jax_with_its_draws(prefix, cfg, n_lattice,
                                                     tol):
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    p0, p1 = (unflatten_tree({k[len(prefix) + 3:]: v
                              for k, v in golden.items()
                              if k.startswith(f"{prefix}p{i}_")})
              for i in (0, 1))
    trainer = PP.PPOTrainer(train_ppo.make_env("cpu"), PP.PPOConfig(**cfg),
                            n_lattice=n_lattice, seed=0)
    PP.load_flax_params(trainer.net, p0)
    trainer._draw = replay(golden, prefix)
    hist = trainer.train(n_updates=1)
    for i, layer in enumerate(trainer.net.dense_layers()):
        want = p1["params"][f"Dense_{i}"]
        for got, ref in ((layer.weight.detach().T, want["kernel"]),
                         (layer.bias.detach(), want["bias"])):
            err = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
            assert err <= tol, (i, ref.shape, err)
    for k, v in hist[0].items():
        np.testing.assert_allclose(v, golden[f"{prefix}metric_{k}"],
                                   rtol=tol, atol=tol, err_msg=k)


def test_torch_ppo_trains_and_makes_progress(tmp_path):
    """The JAX package's own checks at its test size, through
    ``python -m irbfn_tpu_torch.train.train_ppo``'s ``main``: finite
    history, and the cars keep advancing."""
    out = train_ppo.main(["--n_updates", "4", "--n_envs", "16", "--n_steps",
                          "16", "--n_lattice", "5", "--device", "cpu",
                          "--out", str(tmp_path / "curve.json")])
    hist = out["history"]
    assert len(hist) == 4 and out["env_steps_per_s"] > 0
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["reward"])
               for h in hist)
    assert hist[-1]["mean_progress"] > hist[0]["mean_progress"] + 1.0
    assert (tmp_path / "curve.json").exists()
