"""PyTorch port of the fused RBF forward vs the JAX package, on the CPU.

On a CPU tensor ``irbfn_tpu_torch.ops.wcrbf_forward`` runs its plain
PyTorch version; it is held against the flax ``model.apply`` and against
the Pallas kernel run in interpret mode (``wcrbf_forward_pallas(...,
interpret=True)``), following the four cases of ``tests/test_pallas_rbf.py``
with the same tolerances. The CUDA kernel itself is held against this plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irbfn_tpu.models import WCRBFNet as JWCRBFNet
from irbfn_tpu.models import get_basis as jget_basis
from irbfn_tpu.models import kernels as jkernels
from irbfn_tpu.models import wcrbf as jwcrbf
from irbfn_tpu.ops.pallas_rbf import wcrbf_forward_pallas, wcrbf_params_to_pallas
from irbfn_tpu_torch.models import BASIS_FUNCTIONS, WCRBFNet, from_config
from irbfn_tpu_torch.models import wcrbf as twcrbf
from irbfn_tpu_torch.ops import rbf
from irbfn_tpu_torch.train import params_from_jax

torch.set_num_threads(1)

NET = dict(in_features=8, out_features=10, num_kernels=32, num_regions=4,
           lower_bounds=[[-2.0, 0.0], [1.0, 4.0]],
           upper_bounds=[[0.0, 2.0], [4.0, 7.0]],
           dimension_ranges=[[0, 0], [0, 1], [1, 0], [1, 1]],
           activation_idx=[0, 2], delta=[15.0, 100.0])


def _jax_net(seed, **over):
    cfg = dict(NET, **over)
    model = JWCRBFNet(basis_func=jget_basis(cfg.pop("basis_func",
                                                    "gaussian")), **cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8)))
    return model, params


def _port(model, params, dtype=torch.float32):
    """The port's WCRBFNet with the JAX net's config and weights."""
    cfg = {k: getattr(model, k) for k in
           ("in_features", "out_features", "num_kernels", "num_regions",
            "lower_bounds", "upper_bounds", "dimension_ranges",
            "activation_idx", "delta", "input_scale", "head_mode")}
    cfg["basis_func"] = model.basis_func.__name__
    net = from_config(cfg, dtype=dtype, device="cpu")
    net.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return net


def _jax32():
    """The JAX package at its serving precision (x64 off, as its scripts
    run). The test session enables x64, which would lift the flax gate to
    f64: at the far edge of a region box (sum of gammas ~ 1e-9, where the
    normalisation's 1e-9 floor decides) f32 and f64 gates then differ."""
    return jax.enable_x64(False)


def _forward(net, x):
    with torch.no_grad():
        return net(torch.as_tensor(np.asarray(x))).numpy()


@pytest.fixture(scope="module")
def shared_net():
    return _jax_net(3)


def test_torch_rbf_matches_flax_and_pallas(shared_net):
    model, params = shared_net
    x = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    out = _forward(_port(model, params), x)
    with _jax32():
        ref = model.apply(params, jnp.asarray(x))
        pallas = wcrbf_forward_pallas(
            jnp.asarray(x), *wcrbf_params_to_pallas(params, model),
            basis_fn=jget_basis("gaussian"), tile_b=64, interpret=True)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B", [1, 7, 65])
def test_torch_rbf_batch_sizes(shared_net, B):
    """Ragged batches: the port neither pads nor needs a tile multiple."""
    model, params = shared_net
    x = np.random.default_rng(1).normal(size=(B, 8)).astype(np.float32)
    out = _forward(_port(model, params), x)
    assert out.shape == (B, 10)
    with _jax32():
        ref = model.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_torch_rbf_per_region_head():
    """Per-region heads over normalised gammas, with an anisotropic
    input_scale folded into the kernel operands."""
    model, params = _jax_net(
        5, input_scale=(1.0, 0.5, 1.0, 2.0, 1.0, 1.0, 1.0, 1.0),
        head_mode="per_region")
    x = np.random.default_rng(2).normal(size=(100, 8)).astype(np.float32)
    net = _port(model, params)
    out = _forward(net, x)
    with _jax32():
        ref = model.apply(params, jnp.asarray(x))
        scale = jnp.asarray(model.input_scale, jnp.float32)
        pallas = wcrbf_forward_pallas(
            jnp.asarray(x) * scale, *wcrbf_params_to_pallas(params, model),
            basis_fn=jget_basis("gaussian"), tile_b=64, interpret=True)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)
    # in f64 the two packages compute the same function to rounding, except
    # far outside every region box: there 1 + tanh(t) cancels and the folded
    # scale (the port gates on s*x with delta/s) moves the tiny gammas, and
    # outputs of order 1e-7, by a large relative amount
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(
        _forward(_port(model, params, torch.float64), x64),
        model.apply(params, jnp.asarray(x64)), rtol=1e-10, atol=1e-7)


def test_torch_rbf_kernel_operands_match_pallas():
    """wcrbf_params_to_kernel repacks like wcrbf_params_to_pallas: (R, K, O)
    heads, global bias folded into region biases, input_scale folded into
    centers, bounds and delta, +-1e30 bounds on dims that are not split."""
    model, params = _jax_net(
        5, input_scale=(1.0, 0.5, 1.0, 2.0, 1.0, 1.0, 1.0, 1.0),
        head_mode="per_region")
    ops = rbf.wcrbf_params_to_kernel(_port(model, params, torch.float64))
    c, log_sigs, lb, ub, delta, w, b = wcrbf_params_to_pallas(params, model)
    assert ops.per_region and ops.basis == "gaussian"
    for got, want in ((ops.centers, c), (ops.inv_sigs, jnp.exp(-log_sigs)),
                      (ops.lb, lb), (ops.ub, ub), (ops.delta, delta),
                      (ops.w, w), (ops.b, b)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-7)


def test_torch_rbf_distance_cancellation_regime():
    """Large offset mean (||x|| >> ||x - c||): the direct-form distances
    stay within 2e-5 relative of f64, and the forward within 2e-4, where
    the x^2 - 2xc + c^2 form errs ~1e-2."""
    rng = np.random.default_rng(7)
    R, K, F, B = 2, 16, 8, 64
    mean = 100.0 * rng.normal(size=(F,))
    c = (mean[None, None] + 0.1 * rng.normal(size=(R, K, F))).astype(
        np.float32)
    x = (mean[None] + 0.1 * rng.normal(size=(B, F))).astype(np.float32)
    log_sigs = np.zeros((R, K), np.float32)
    d_ref = np.sqrt(((x.astype(np.float64)[:, None, None]
                      - c.astype(np.float64)[None]) ** 2).sum(-1))
    d = twcrbf.rbf_distances(torch.from_numpy(x), torch.from_numpy(c),
                             torch.from_numpy(log_sigs))
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=2e-5)

    net = WCRBFNet(F, K, K, "gaussian", R, [[-1e30]], [[1e30]], [[0], [0]],
                   [0], [1.0], device="cpu")
    net.load_state_dict({"centers": torch.from_numpy(c),
                         "log_sigs": torch.from_numpy(log_sigs),
                         "head_kernel": torch.eye(K),
                         "head_bias": torch.zeros(K)})
    gref = np.exp(-d_ref ** 2).sum(1)
    np.testing.assert_allclose(_forward(net, x), gref, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(BASIS_FUNCTIONS))
def test_torch_basis_functions(name):
    """All 15 basis functions, in the registry order the CUDA kernel
    indexes, against irbfn_tpu.models.kernels in f64."""
    assert list(BASIS_FUNCTIONS) == list(jkernels.BASIS_FUNCTIONS)
    alpha = np.linspace(0.0, 6.0, 301)
    np.testing.assert_allclose(
        BASIS_FUNCTIONS[name](torch.from_numpy(alpha)).numpy(),
        np.asarray(jkernels.BASIS_FUNCTIONS[name](jnp.asarray(alpha))),
        rtol=1e-12, atol=1e-12)
    assert rbf.BASIS_IDS[name] == list(jkernels.BASIS_FUNCTIONS).index(name)


def test_torch_region_activation_and_distances_f64():
    rng = np.random.default_rng(9)
    lb, ub = jwcrbf.build_region_bounds(
        NET["lower_bounds"], NET["upper_bounds"], NET["dimension_ranges"],
        NET["activation_idx"])
    lb_t, ub_t = twcrbf.build_region_bounds(
        NET["lower_bounds"], NET["upper_bounds"], NET["dimension_ranges"],
        NET["activation_idx"])
    np.testing.assert_array_equal(lb, lb_t)
    np.testing.assert_array_equal(ub, ub_t)
    x = rng.normal(1.0, 2.0, size=(33, 8))
    delta = np.asarray(NET["delta"], np.float64)
    np.testing.assert_allclose(
        twcrbf.region_activation(torch.from_numpy(x), torch.from_numpy(lb),
                                 torch.from_numpy(ub),
                                 torch.from_numpy(delta),
                                 NET["activation_idx"]).numpy(),
        jwcrbf.region_activation(jnp.asarray(x), lb, ub, delta,
                                 tuple(NET["activation_idx"])),
        rtol=1e-12, atol=1e-15)
    c = rng.normal(size=(4, 16, 8))
    ls = rng.uniform(-1, 1, size=(4, 16))
    s = tuple(rng.uniform(0.5, 2.0, 8))
    np.testing.assert_allclose(
        twcrbf.rbf_distances(torch.from_numpy(x), torch.from_numpy(c),
                             torch.from_numpy(ls), s).numpy(),
        jwcrbf.rbf_distances(jnp.asarray(x), jnp.asarray(c),
                             jnp.asarray(ls), s), rtol=1e-12)


def test_torch_rbf_dispatch_by_device(shared_net):
    """CPU tensors take the plain version without counting a launch; a
    device that is neither CPU nor CUDA raises (there is no fallback)."""
    model, params = shared_net
    net = _port(model, params)
    before = rbf.wcrbf_forward.launches
    _forward(net, np.zeros((3, 8), np.float32))
    assert rbf.wcrbf_forward.launches == before
    ops = rbf.wcrbf_params_to_kernel(net)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rbf.wcrbf_forward(torch.zeros((3, 8), device="meta"), ops)


def test_torch_rbf_not_ported_models_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_config({"model_class": "DeeperWCRBFNet"})
