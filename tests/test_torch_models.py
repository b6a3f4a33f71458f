"""The port's model classes vs flax, on the CPU.

The same numpy inputs and the same weights (flax's seeded initial values,
moved across by ``params_from_jax``) go through the flax modules and through
``irbfn_tpu_torch.models``: forwards and parameter gradients in f64. The
WCRBFNet's two routes (the module path under autograd, the fused op
otherwise) are held against each other and to the rule that picks one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu import models as jmodels
from irbfn_tpu_torch import models as tmodels
from irbfn_tpu_torch.models import wcrbf as twcrbf
from irbfn_tpu_torch.ops import rbf
from irbfn_tpu_torch.parallel import controls_block
from irbfn_tpu_torch.train import params_from_jax, params_to_jax

torch.set_num_threads(1)

TOL_F64 = dict(rtol=1e-10, atol=1e-10)  # same f64 arithmetic in both
GEO = dict(lower_bounds=[[-2.0, 0.0], [1.0, 4.0]],
           upper_bounds=[[0.0, 2.0], [4.0, 7.0]],
           dimension_ranges=[[0, 0], [0, 1], [1, 0], [1, 1]],
           activation_idx=[0, 2], delta=[15.0, 3.0])
SCALE = (1.5, 0.7, 0.3, 1.0, 1.0, 0.5, 2.0, 4.0)
CONFIGS = {
    "WCRBFNet-shared": dict(model_class="WCRBFNet", num_regions=4,
                            head_mode="shared", **GEO),
    "WCRBFNet-per_region": dict(model_class="WCRBFNet", num_regions=4,
                                head_mode="per_region", input_scale=SCALE,
                                basis_func="inverse_quadratic", **GEO),
    "DeeperWCRBFNet": dict(model_class="DeeperWCRBFNet", num_regions=4,
                           input_scale=SCALE, **GEO),
    "MLP": dict(model_class="MLP", num_regions=4, **GEO),
    "ClusterWCRBFNet": dict(model_class="ClusterWCRBFNet", num_regions=5,
                            input_scale=SCALE, basis_func="matern32"),
}


def _config(name):
    return dict(dict(in_features=8, out_features=6, num_kernels=12,
                     basis_func="gaussian"), **CONFIGS[name])


def _pair(name, seed=0):
    """(flax model, its f64 variables, the port's f64 model with them)."""
    config = _config(name)
    jmodel = jmodels.from_config(config)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8)))
    rng = np.random.default_rng(seed)
    # flax starts biases and log-widths at 0: make every leaf count
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        + 0.1 * rng.standard_normal(a.shape), variables)
    net = tmodels.from_config(config, dtype=torch.float64, device="cpu")
    net.load_state_dict(params_from_jax(variables, config))
    return config, jmodel, variables, net


def _x(n=33, seed=1):
    """Inputs inside the region boxes: far outside them every gate is
    ``1 + tanh(t)`` at t << 0, which cancels to a few digits, and the
    normalised gates of two tanh implementations then differ by ~1e-8."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.5, (n, 8))
    x[:, 0] = rng.uniform(-1.9, 1.9, n)
    x[:, 2] = rng.uniform(1.1, 6.9, n)
    return x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_torch_models_forward_and_gradients_match_flax(name):
    """Forward, and the gradient of a scalar of the output with respect to
    every parameter and to the input, in f64."""
    config, jmodel, variables, net = _pair(name)
    x = _x()
    w = np.random.default_rng(2).standard_normal((x.shape[0], 6))

    def scalar(v, xb):
        out = jmodel.apply(v, xb)
        extra = 0.0
        if isinstance(out, tuple):
            out, logits = out
            extra = jnp.sum(jnp.sin(logits))
        return jnp.sum(out * w) + extra

    ref = jmodel.apply(variables, jnp.asarray(x))
    gv, gx = jax.grad(scalar, argnums=(0, 1))(variables, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = net(xt)
    if isinstance(out, tuple):
        np.testing.assert_allclose(out[1].detach().numpy(), ref[1], **TOL_F64)
        total = (out[0] * torch.from_numpy(w)).sum() + torch.sin(out[1]).sum()
        out, ref = out[0], ref[0]
    else:
        total = (out * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL_F64)
    total.backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL_F64)
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, gv), config)
    assert sorted(grads) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k], g.numpy(), err_msg=k, **TOL_F64)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_torch_params_to_jax_inverts_params_from_jax(name):
    """The port's state_dict as a flax tree: the same structure and leaves
    as flax's own variables, and flax's forward on it equals the port's."""
    config, jmodel, variables, net = _pair(name, seed=3)
    tree = params_to_jax(net.state_dict(), config)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, dict(variables)))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(dict(variables))):
        np.testing.assert_array_equal(a, b)
    back = params_from_jax(tree, config)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("fixed_centers,fixed_width", [(True, False),
                                                       (True, True)])
def test_torch_wcrbf_frozen_centers_and_widths(fixed_centers, fixed_width):
    """``centers=`` warm-starts the bank (shared over the regions), and the
    frozen tensors take no gradient, stay out of the optimizer's reach and
    go to flax's ``constants`` collection."""
    bank = np.random.default_rng(4).normal(size=(12, 8))
    config = dict(_config("WCRBFNet-shared"), fixed_centers=fixed_centers,
                  fixed_width=fixed_width)
    jmodel = jmodels.from_config(config, centers=bank)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.ones((1, 8))))
    assert "centers" in variables["constants"]["core"]
    net = tmodels.from_config(config, dtype=torch.float64, device="cpu",
                              centers=bank, seed=0)
    assert not net.centers.requires_grad
    assert net.log_sigs.requires_grad == (not fixed_width)
    # (flax's initialiser makes the warm start f32, the port keeps f64)
    np.testing.assert_allclose(net.centers.numpy(),
                               variables["constants"]["core"]["centers"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(net.centers.numpy()[0], bank)
    tree = params_to_jax(net.state_dict(), config)
    assert jax.tree.structure(tree) == jax.tree.structure(dict(variables))
    x = _x(9)
    net(torch.from_numpy(x)).sum().backward()
    assert net.centers.grad is None and net.head_kernel.grad is not None
    ref = jmodel.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), ref,
                                   **TOL_F64)


@pytest.mark.parametrize("head_mode", ["shared", "per_region"])
def test_torch_wcrbf_forward_dispatch_rule(head_mode, monkeypatch):
    """Autograd recording with a parameter or the input requiring a
    gradient: the module path, and the fused op is not called. Otherwise
    the fused op is. Both give the same numbers."""
    _, _, _, net = _pair(f"WCRBFNet-{head_mode}")
    net = net.float()
    calls = []
    real = rbf.wcrbf_forward
    monkeypatch.setattr(twcrbf._rbf, "wcrbf_forward",
                        lambda x, ops: calls.append(1) or real(x, ops))
    x = torch.from_numpy(_x(17)).float()
    y_grad = net(x)  # parameters require gradients, autograd records
    assert not calls and y_grad.requires_grad
    with torch.no_grad():
        y_fused = net(x)
    assert len(calls) == 1 and not y_fused.requires_grad
    np.testing.assert_allclose(y_grad.detach().numpy(), y_fused.numpy(),
                               rtol=2e-5, atol=2e-5)
    for p in net.parameters():
        p.requires_grad_(False)
    net(x)  # nothing requires a gradient: the fused op, autograd on or off
    assert len(calls) == 2
    assert net(x.clone().requires_grad_(True)).requires_grad  # the input does
    assert len(calls) == 2


def test_torch_wcrbf_operand_cache_sees_optimizer_updates():
    """Adam updates the weights in place; the next no-grad forward must use
    them (the packed-operand cache keys on the tensors' versions)."""
    _, _, _, net = _pair("WCRBFNet-per_region")
    net = net.float()
    x = torch.from_numpy(_x(17)).float()
    with torch.no_grad():
        before = net(x)
        ops_before = net.kernel_operands()
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    net(x).square().sum().backward()
    opt.step()
    with torch.no_grad():
        after = net(x)
        assert net.kernel_operands() is not ops_before
    assert not torch.allclose(after, before)
    np.testing.assert_allclose(after.numpy(),
                               net.forward_module(x).detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_torch_overlapping_segments_and_from_config():
    vals = np.random.default_rng(5).uniform(-3, 3, 17)
    for n_seg, ov in ((1, 1), (2, 1), (3, 2), (4, 0)):
        assert (tmodels.overlapping_segments(vals, n_seg, ov)
                == jmodels.overlapping_segments(vals, n_seg, ov))
    for name in CONFIGS:
        net = tmodels.from_config(_config(name), device="cpu")
        assert type(net).__name__ == _config(name)["model_class"]
        assert all(float(p.detach().abs().sum()) == 0.0
                   for p in net.parameters())
    with pytest.raises(KeyError, match="model_class"):
        tmodels.from_config(dict(_config("MLP"), model_class="Transformer"))


def test_torch_reset_parameters_is_seeded():
    a = tmodels.from_config(_config("DeeperWCRBFNet"), device="cpu", seed=7)
    b = tmodels.from_config(_config("DeeperWCRBFNet"), device="cpu", seed=7)
    c = tmodels.from_config(_config("DeeperWCRBFNet"), device="cpu", seed=8)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.pre1_kernel, c.pre1_kernel)
    assert float(a.head_bias.detach().abs().sum()) == 0.0
    assert float(a.log_sigs.detach().abs().sum()) == 0.0
    # LeCun normal: variance 1/fan_in, truncated at two standard deviations
    big = tmodels.MLP(512, 4, 1024, device="cpu", seed=0).dense0_kernel
    assert abs(float(big.detach().std()) * 512 ** 0.5 - 1.0) < 0.02
    assert (float(big.detach().abs().max())
            <= 2.0 / (0.87962566103423978 * 512 ** 0.5))


def test_torch_controls_block_layout():
    """(N, T, 2) table outputs flatten to the BLOCK layout [a0..aT, sv0..svT]
    the nets are trained on, not the interleaved order of a plain reshape
    (which would make the planner steer with sv_2); -999 rows stay -999."""
    from irbfn_tpu.parallel.datagen import controls_block as jcontrols_block

    T = 5
    accel = np.arange(10, 10 + T, dtype=np.float32)
    sv = np.arange(20, 20 + T, dtype=np.float32)
    out3 = np.stack([np.stack([accel, sv], axis=-1),
                     np.full((T, 2), -999.0, np.float32)])  # (2, T, 2)
    flat = controls_block(out3)
    np.testing.assert_array_equal(flat[0, :T], accel)
    np.testing.assert_array_equal(flat[0, T:], sv)
    assert flat[0, T] == sv[0] and out3.reshape(2, -1)[0, T] == sv[2]
    assert (flat[1] == -999.0).all()
    np.testing.assert_array_equal(flat, jcontrols_block(out3))
    np.testing.assert_array_equal(controls_block(flat), flat)
