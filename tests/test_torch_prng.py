"""The port's JAX random streams (``irbfn_tpu_torch/utils/prng.py``) against
``jax.random`` itself, in f32 as the JAX scripts run (x64 off), on the CPU.

Every draw is held bit for bit, the normal family included: ``normal``,
``truncated_normal`` and ``gumbel`` pass through XLA's f32 ``erf_inv``,
``log1p`` and ``log``, which the port writes out in XLA:CPU's order, so the
largest gap measured is 0 ulp (seeds 0, 1, 123 and 2**31 - 1 at the shapes
below, and 2**20 draws of each at seeds 0 and 7).

- keys: ``key_data`` of split chains and of ``fold_in``;
- 32-bit bits, ``uniform`` with bounds, the normal family, at (7,),
  (1000, 3) and (3, 5, 64);
- ``categorical`` on random logits, ``choice`` with ``p`` at 3 and 12 arms,
  ``permutation`` of 64 and 4,096;
- flax's initial weights: the five module classes built with a key against
  ``module.init`` of the JAX classes at a small width, and a start-noise
  ``reset`` against the JAX env's;
- the trainers' keys: ``train_frenet`` and ``train_cartesian`` shuffle with
  ``key_data(split(PRNGKey(s))[0])[-1]`` (fault P6, repaired) and
  ``train_goal_mpc`` with ``s``, as the JAX scripts do (``train_clothoid``:
  ``tests/test_torch_clothoid.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 123, 2**31 - 1]
SHAPES = [(7,), (1000, 3), (3, 5, 64)]


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def _same_bits(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_chains_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_data(tk), _words(jk))
    for step in range(16):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tk.numpy(), _words(jk))
        np.testing.assert_array_equal(tsub.numpy(), _words(jsub))
        jf = jax.random.fold_in(jsub, step * 7919)
        np.testing.assert_array_equal(prng.fold_in(tsub, step * 7919).numpy(),
                                      _words(jf))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  _words(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(prng.split(tk, (2, 3)).numpy(),
                                  _words(jax.random.split(jk, (2, 3))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_the_normal_family(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same_bits(prng.bits(tk, shape), jax.random.bits(jk, shape))
    _same_bits(prng.uniform(tk, shape), jax.random.uniform(jk, shape))
    _same_bits(prng.uniform(tk, shape, minval=-3.0, maxval=5.5),
               jax.random.uniform(jk, shape, minval=-3.0, maxval=5.5))
    _same_bits(prng.normal(tk, shape), jax.random.normal(jk, shape))
    _same_bits(prng.truncated_normal(tk, -2, 2, shape),
               jax.random.truncated_normal(jk, -2, 2, shape))
    _same_bits(prng.gumbel(tk, shape), jax.random.gumbel(jk, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_on_random_logits(seed):
    logits = np.random.default_rng(seed).normal(0, 2, (256, 7)).astype(
        np.float32)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same_bits(prng.categorical(tk, torch.from_numpy(logits)),
               jax.random.categorical(jk, jnp.asarray(logits)))


@pytest.mark.parametrize("n", [3, 12])
@pytest.mark.parametrize("seed", SEEDS)
def test_choice_with_p(seed, n):
    rng = np.random.default_rng(seed)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got, want = [], []
    for _ in range(100):
        p = rng.dirichlet(np.ones(n)).astype(np.float32)
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        want.append(int(jax.random.choice(jsub, n, p=jnp.asarray(p))))
        got.append(int(prng.choice(tsub, n, torch.from_numpy(p))))
    assert got == want


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed, n):
    _same_bits(prng.permutation(prng.PRNGKey(seed), n),
               jax.random.permutation(jax.random.PRNGKey(seed), n))


# ------------------------------------------------------- initial weights

GEO = dict(lower_bounds=[[-2.0, 0.0], [1.0, 4.0]],
           upper_bounds=[[0.0, 2.0], [4.0, 7.0]],
           dimension_ranges=[[0, 0], [0, 1], [1, 0], [1, 1]],
           activation_idx=[0, 2], delta=[15.0, 3.0])
MODELS = {
    "WCRBFNet": dict(model_class="WCRBFNet", num_regions=4,
                     head_mode="per_region", **GEO),
    "WCRBFNet-fixed_centers": dict(model_class="WCRBFNet", num_regions=4,
                                   fixed_centers=True, **GEO),
    "DeeperWCRBFNet": dict(model_class="DeeperWCRBFNet", num_regions=4,
                           **GEO),
    "MLP": dict(model_class="MLP", num_regions=4, **GEO),
    "ClusterWCRBFNet": dict(model_class="ClusterWCRBFNet", num_regions=5),
}


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("name", list(MODELS))
def test_flax_initial_weights(name, seed):
    """``from_config(..., key=k)`` holds what ``module.init(k, x)`` gives
    the JAX class, every tensor bit for bit (f32)."""
    from irbfn_tpu import models as jmodels
    from irbfn_tpu_torch import models as tmodels
    from irbfn_tpu_torch.train import params_from_jax

    config = dict(in_features=8, out_features=6, num_kernels=12,
                  basis_func="gaussian", **MODELS[name])
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    variables = jmodels.from_config(config).init(jkey, jnp.ones((1, 8)))
    want = params_from_jax(jax.tree.map(np.asarray, variables), config)
    key = prng.split(prng.PRNGKey(seed))[1]
    net = tmodels.from_config(config, device="cpu", key=key)
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.dtype == torch.float32, k
        _same_bits(got[k], v.numpy())
    # seed=s is PRNGKey(s)
    by_seed = tmodels.from_config(config, device="cpu", seed=seed)
    by_key = tmodels.from_config(config, device="cpu",
                                 key=prng.PRNGKey(seed))
    for k, v in by_seed.state_dict().items():
        assert torch.equal(v, by_key.state_dict()[k]), k


@pytest.mark.parametrize("seed", [0, 123])
def test_flax_initial_weights_actor_critic(seed):
    from irbfn_tpu.train import ppo as JP
    from irbfn_tpu_torch.train import ppo as PP

    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    params = JP.ActorCritic(n_actions=5).init(jkey, jnp.zeros((1, 8)))
    net = PP.ActorCritic(5, key=prng.split(prng.PRNGKey(seed))[1])
    for i, layer in enumerate(net.dense_layers()):
        d = params["params"][f"Dense_{i}"]
        _same_bits(layer.weight.detach().T.contiguous(), d["kernel"])
        _same_bits(layer.bias.detach(), d["bias"])


def test_reset_start_noise_matches_jax():
    """``TrackEnv.reset(key=...)``: the JAX env's start poses from the same
    key, f32 (0.01 m/rad of noise on 1000 lanes)."""
    from irbfn_tpu.dynamics import f1tenth_params as jparams
    from irbfn_tpu.sim import TrackEnv as JEnv
    from irbfn_tpu.sim import oval_track as joval
    from irbfn_tpu_torch.dynamics import f1tenth_params
    from irbfn_tpu_torch.sim import TrackEnv, oval_track

    jenv = JEnv(joval(n_samples=256, speed=3.0),
                jparams(dtype=jnp.float32))
    tenv = TrackEnv(oval_track(n_samples=256, speed=3.0, device="cpu"),
                    f1tenth_params(dtype=torch.float32, device="cpu"))
    jk = jax.random.split(jax.random.PRNGKey(0))[1]
    tk = prng.split(prng.PRNGKey(0))[1]
    js = jenv.reset(s0=jnp.zeros(1000), speed0=1.0, key=jk, noise_scale=0.01,
                    batch_shape=(1000,))
    ts = tenv.reset(s0=0.0, speed0=1.0, key=tk, noise_scale=0.01,
                    batch_shape=(1000,))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-6)
    noise = 0.01 * prng.normal(tk, (1000, 3))
    assert float(noise.abs().max()) > 0.02  # the noise is there


# ------------------------------------------------------ the trainers' keys

def _capture(monkeypatch, module):
    """Wrap ``module.train_epochs``: record the seed it is handed, the rows
    and the first batch its step sees."""
    real = module.train_epochs
    seen = {}

    def wrapper(trainer, step_fn, inputs, outputs, batch_size, epochs,
                seed=None, **kw):
        seed = kw.pop("seed", seed)
        seen.update(seed=seed, inputs=np.asarray(torch.as_tensor(
            inputs).cpu()), batch=min(batch_size, len(inputs)))

        def step(trainer, x, *rest):
            seen.setdefault("first", x.detach().cpu().numpy())
            return step_fn(trainer, x, *rest)

        return real(trainer, step, inputs, outputs, batch_size, epochs,
                    seed, **kw)

    monkeypatch.setattr(module, "train_epochs", wrapper)
    return seen


def _grid(axes):
    return np.stack([m.reshape(-1) for m in np.meshgrid(
        *axes, indexing="ij")], -1).astype(np.float32)


def _frenet_table(path):
    inputs = _grid([np.linspace(-0.4, 0.4, 3), [0.0], np.linspace(2, 6, 3),
                    [0.0], np.linspace(3, 6, 2), [0.0],
                    np.linspace(-0.3, 0.3, 3), np.linspace(-0.1, 0.1, 2)])
    accel = np.tanh(inputs[:, 4:5] - inputs[:, 2:3]) * np.linspace(1, .5, 5)
    sv = (-inputs[:, 0:1] - inputs[:, 6:7]) * np.linspace(1, .2, 5)
    np.savez(path, inputs=inputs,
             outputs=np.stack([accel, sv], -1).astype(np.float32))


def _cartesian_table(path):
    inputs = _grid([np.linspace(1, 3, 2), np.linspace(1, 2, 3),
                    np.linspace(-0.5, 0.5, 3), np.linspace(-0.2, 0.2, 2),
                    np.linspace(1, 3, 2), [0.0], [0.0]])
    outputs = np.concatenate([
        np.tanh(inputs[:, 4:5] - inputs[:, 0:1]) * np.ones(5),
        -0.5 * inputs[:, 2:3] * np.linspace(1, .2, 5)], 1)
    np.savez(path, inputs=inputs, outputs=outputs.astype(np.float32))


def _goal_table(path):
    inputs = _grid([np.linspace(0.5, 2, 3), np.linspace(1, 2, 3),
                    np.linspace(-0.5, 0.5, 3), np.linspace(-0.3, 0.3, 3),
                    np.linspace(1, 3, 3)])
    outputs = np.stack([inputs[:, 4] - 0.1 * inputs[:, 1],
                        0.5 * inputs[:, 2] + 0.2 * inputs[:, 3]], 1)
    np.savez(path, inputs=inputs, outputs=outputs.astype(np.float32),
             valid=np.ones(len(inputs), bool))


TRAINERS = {
    "train_frenet": (_frenet_table, ["--train_epochs", "1", "--batch_size",
                                     "16", "--num_k", "8"], True),
    "train_cartesian": (_cartesian_table, ["--train_epochs", "1",
                                           "--batch_size", "16", "--num_k",
                                           "8"], True),
    "train_goal_mpc": (_goal_table, ["--finetune_epochs", "1", "--batch",
                                     "16", "--num_k", "8"], False),
}


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainers_shuffle_with_the_jax_scripts_seed(name, seed, tmp_path,
                                                    monkeypatch):
    """The seed each trainer hands ``train_epochs``, and the first batch it
    trains on, are the JAX script's: the last word of ``split(PRNGKey(s))
    [0]`` for the Frenet and cartesian trainers (which split the key for
    the net first), ``s`` itself for ``train_goal_mpc``."""
    import importlib

    module = importlib.import_module(f"irbfn_tpu_torch.train.{name}")
    make, flags, split_first = TRAINERS[name]
    path = str(tmp_path / "table.npz")
    make(path)
    seen = _capture(monkeypatch, module)
    module.main(["--npz_path", path, "--seed", str(seed), "--device", "cpu",
                 "--out_dir", str(tmp_path), "--run_name", "r"] + flags)
    want = seed
    if split_first:
        want = int(np.asarray(jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(seed))[0]))[-1])
        assert want != seed
    assert seen["seed"] == want
    first = np.random.default_rng(want).permutation(
        len(seen["inputs"]))[:seen["batch"]]
    np.testing.assert_array_equal(seen["first"], seen["inputs"][first])
