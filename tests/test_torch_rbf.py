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
from irbfn_tpu_torch.utils import spans

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
    before = spans.counters().get("ops.rbf.forwards", 0)
    _forward(net, np.zeros((3, 8), np.float32))
    assert spans.counters().get("ops.rbf.forwards", 0) == before
    ops = rbf.wcrbf_params_to_kernel(net)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rbf.wcrbf_forward(torch.zeros((3, 8), device="meta"), ops)


def _random_operands(rng, R, K, F, O, per_region, dtype=torch.float32):
    """RBFOperands with numpy-drawn weights in the plain layout, packed."""
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    centers = t(rng.normal(size=(R, K, F)))
    inv_sigs = t(rng.uniform(0.5, 2.0, (R, K)))
    w = t(rng.normal(size=(R, K, O) if per_region else (K, O)))
    b = t(rng.normal(size=(R, O) if per_region else (O,)))
    lb = t(np.where(rng.random((R, F)) < 0.5, -1e30, -1.0))
    ub = t(np.where(rng.random((R, F)) < 0.5, 1e30, 1.0))
    return rbf.RBFOperands(centers, inv_sigs, lb, ub, t(np.ones(F)), w, b,
                           "gaussian", *rbf.pack_operands(centers, inv_sigs,
                                                          w))


@pytest.mark.parametrize("per_region", [True, False])
@pytest.mark.parametrize("R,K,F,O", [(4, 32, 8, 10), (3, 100, 5, 2),
                                     (2, 64, 12, 17), (1, 512, 16, 1)])
def test_torch_rbf_packed_operands_hold_the_plain_ones(R, K, F, O,
                                                       per_region):
    """The kernel's layout: centers (R, FP + 1, Kp) with the widths as the
    last row, heads (R, O, Kp) | (O, Kp); unpacking gives the plain layout
    back bit for bit, every pad is zero, and every row starts on a 16-byte
    boundary."""
    ops = _random_operands(np.random.default_rng(11), R, K, F, O, per_region)
    cp, wp = ops.c_packed, ops.w_packed
    FP = 8 if F <= 8 else 16
    Kp = -(-K // 32) * 32
    assert rbf.packed_features(F) == FP
    assert cp.shape == (R, FP + 1, Kp)
    assert wp.shape == ((R, O, Kp) if per_region else (O, Kp))
    for got, want in zip(rbf.unpack_operands(cp, wp, K, F),
                         (ops.centers, ops.inv_sigs, ops.w)):
        assert torch.equal(got, want)
    assert not cp[:, :, K:].any() and not wp[..., K:].any()
    assert not cp[:, F:FP].any()
    for t in (cp, wp):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert (t.stride(-2) * t.element_size()) % 16 == 0
    # the rows as the kernel indexes them
    r, k = R - 1, K - 1
    assert cp[r, F - 1, k] == ops.centers[r, k, F - 1]
    assert cp[r, FP, k] == ops.inv_sigs[r, k]
    assert (wp[r, O - 1, k] if per_region else wp[O - 1, k]) == (
        ops.w[r, k, O - 1] if per_region else ops.w[k, O - 1])


@pytest.mark.parametrize("head_mode", ["shared", "per_region"])
def test_torch_rbf_model_operands_packed_once(head_mode):
    """WCRBFNet.kernel_operands packs once per set of weights: the same
    object on every forward, a new one after the weights change, and its
    packed tensors always the plain ones repacked."""
    model, params = _jax_net(5, head_mode=head_mode)
    net = _port(model, params)
    x = np.random.default_rng(3).normal(size=(9, 8)).astype(np.float32)
    with torch.no_grad():
        first = net.kernel_operands()
        out = net(torch.from_numpy(x))
        assert net.kernel_operands() is first
        K, F = first.centers.shape[1:]
        for got, want in zip(
                rbf.unpack_operands(first.c_packed, first.w_packed, K, F),
                (first.centers, first.inv_sigs, first.w)):
            assert torch.equal(got, want)
        before = first.centers.clone()  # without a scale it is the weight
        net.centers.add_(0.25)
        second = net.kernel_operands()
        assert second is not first
        assert torch.equal(second.centers, before + 0.25)
        assert torch.equal(second.c_packed[:, :F, :K],
                           second.centers.transpose(1, 2))
        assert not torch.allclose(net(torch.from_numpy(x)), out)
        state = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        assert net.kernel_operands() is not second
    with _jax32():
        ref = model.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    # while autograd records, the operands stay functions of the weights
    net.centers.requires_grad_(True)
    net(torch.from_numpy(x)).sum().backward()
    assert net.centers.grad is not None and net.centers.grad.abs().sum() > 0


@pytest.mark.parametrize("B,expect", [(1, (1, 1)), (7, (1, 1)),
                                      (1024, (2, 2)), (4096, (8, 2)),
                                      (100000, (16, 2))])
def test_torch_rbf_launch_plan_flagship(B, expect):
    """Regions per block and stages at the flagship width on a 132-SM card:
    one region per block while the batch is small, about two blocks per SM
    beyond, double-buffered when a block loops over regions."""
    assert rbf.launch_plan(B, 16, 512, 8, 10, 132) == expect


def test_torch_rbf_launch_plan_limits():
    """Uneven region counts are split into even groups; a tile too large for
    two stages takes one; one too large for the card raises."""
    assert rbf.launch_plan(4096, 5, 100, 8, 17, 132) == (2, 2)  # 2, 2, 1
    assert rbf.launch_plan(2624, 16, 512, 8, 10, 132) == (4, 2)  # not 5
    assert rbf.launch_plan(512, 16, 512, 8, 10, 132)[0] == 1
    # 33 rows of 1024 floats: 135 KB a stage, two do not fit
    assert rbf.launch_plan(4096, 16, 1024, 16, 16, 132) == (8, 1)
    assert rbf.smem_bytes(512, 8, 10, 2, 2) == 4 * (2 * (21 * 512 + 16) + 64)
    assert rbf.smem_bytes(100, 5, 2, 1, 1) == 4 * (13 * 128 + 16 + 32)
    with pytest.raises(ValueError, match="shared memory"):
        rbf.launch_plan(1024, 16, 2048, 16, 16, 132)


def test_torch_rbf_launch_checks_raise():
    """The kernel wrapper refuses what the kernel does not take before it
    reaches the card: other types, too many features, operands that were
    not packed or do not agree, packed data off a 16-byte boundary."""
    rng = np.random.default_rng(12)
    ops = _random_operands(rng, 2, 32, 8, 3, True)
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="f32"):
        rbf._launch(x.double(), ops)
    with pytest.raises(ValueError, match="f32"):
        rbf._launch(x, ops._replace(lb=ops.lb.double()))
    with pytest.raises(ValueError, match="contiguous"):
        rbf._launch(x, ops._replace(b=ops.b.T.contiguous().T))
    with pytest.raises(ValueError, match="at most 16 features"):
        rbf._launch(torch.zeros((4, 17)),
                    _random_operands(rng, 2, 32, 17, 3, True))
    with pytest.raises(ValueError, match="packed"):
        rbf._launch(x, ops._replace(c_packed=None))
    with pytest.raises(ValueError, match="do not agree"):
        rbf._launch(x, ops._replace(ub=ops.ub[:1].contiguous()))
    with pytest.raises(ValueError, match="do not agree"):
        rbf._launch(x, ops._replace(w_packed=ops.w_packed[0].contiguous()))
    with pytest.raises(ValueError, match="do not agree"):
        rbf._launch(torch.zeros((4, 7)), ops)
    flat = torch.zeros(ops.w_packed.numel() + 1)
    off = flat[1:].view(ops.w_packed.shape).copy_(ops.w_packed)
    with pytest.raises(ValueError, match="16-byte"):
        rbf._launch(x, ops._replace(w_packed=off))
    with pytest.raises(ValueError, match="no basis"):
        rbf._launch(x, ops._replace(basis="sinc"))
    with pytest.raises(RuntimeError, match="no backward"):
        rbf._launch(x.requires_grad_(True), ops)
    # a 17-feature net packs nothing and still runs its plain version
    net = WCRBFNet(17, 3, 32, "gaussian", 2, [[-1.0, 0.0]], [[0.0, 1.0]],
                   [[0], [1]], [0], [5.0], device="cpu")
    wide = net.kernel_operands()
    assert wide.c_packed is None and wide.w_packed is None
    with torch.no_grad():
        assert net(torch.zeros((4, 17))).shape == (4, 3)


@pytest.mark.parametrize("per_region", [True, False])
def test_torch_rbf_reference_ignores_the_packed_layout(per_region):
    """The plain version reads the plain layout only: operands with and
    without the packed tensors give the same bits."""
    rng = np.random.default_rng(13)
    ops = _random_operands(rng, 4, 100, 5, 17, per_region)
    x = torch.as_tensor(rng.normal(size=(33, 5)), dtype=torch.float32)
    bare = ops._replace(c_packed=None, w_packed=None)
    assert torch.equal(rbf.wcrbf_forward(x, ops),
                       rbf.wcrbf_forward(x, bare))


def test_torch_rbf_not_ported_models_raise():
    """Every model class of the JAX package is ported: only a class that
    neither package has raises, and by its name."""
    from irbfn_tpu.models import _MODEL_CLASSES
    from irbfn_tpu_torch.models import MODEL_CLASSES

    assert sorted(MODEL_CLASSES) == sorted(_MODEL_CLASSES)
    with pytest.raises(KeyError, match="GatedWCRBFNet"):
        from_config({"model_class": "GatedWCRBFNet"})
