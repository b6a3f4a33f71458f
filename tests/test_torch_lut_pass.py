"""A net's pass over a goal grid (``eval_lut_accuracy.net_params``) on the
port's lattice chunk loop, on the CPU: against the benchmark's plain float64
reference (``benchmark/reference/wcrbf.py``) for a seeded random
``WCRBFNet`` (R=8, K=32, F=3, O=5, gaussian, per-region heads) and for the
committed ``clothoid_pr`` net at its full widths; bit for bit the loop it
replaced, chunk for chunk; and the chunk loop's counters.

Tolerances, on |p - p_ref| / (1 + |p_ref|) as the benchmark's cell judges
it: the port's CPU forward is the plain float32 version, whose gate
products, distances and head sums round at ~1e-7 relative a step; the
small net's head sums 264 terms (measured: 1.6e-6), the committed net's
32,896 (measured: 3.6e-5 on the 256 goals here), so 2e-5 and 2e-4 leave
five to ten times the room; the small net's forward one precision down
(the reference's bfloat16 control) misses by three orders of magnitude
(0.033).
"""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import wcrbf as ref_wcrbf
from irbfn_tpu_torch.models import from_config
from irbfn_tpu_torch.train import load_model
from irbfn_tpu_torch.train.checkpoints import save_checkpoint, save_config
from irbfn_tpu_torch.train.eval_lut_accuracy import net_params
from irbfn_tpu_torch.utils import spans

ASSET = "irbfn_tpu_torch/assets/clothoid_pr"
# the LUT's ranges (x, y, theta), a coarse 'ij' grid of them
BOX = np.array([[5.0, 30.0], [-8.0, 8.0], [-1.57, 1.57]])


def _grid(nx: int, ny: int, nt: int) -> np.ndarray:
    axes = [np.linspace(lo, hi, n) for (lo, hi), n in zip(BOX, (nx, ny, nt))]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


def _gap(got: np.ndarray, want: torch.Tensor) -> float:
    want = want.numpy()
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


def _old_loop(model, goals: np.ndarray, chunk: int) -> np.ndarray:
    """The loop ``net_params`` had before the lattice chunk loop: a
    pageable copy in, the forward, a blocking copy back, a chunk at a
    time."""
    out = np.empty((goals.shape[0], model.out_features), np.float32)
    with torch.no_grad():
        for i0 in range(0, goals.shape[0], chunk):
            x = torch.as_tensor(goals[i0:i0 + chunk], dtype=torch.float32)
            out[i0:i0 + chunk] = model(x).cpu().numpy()
    return out


@pytest.fixture(scope="module")
def small_net(tmp_path_factory):
    """A seeded random per-region WCRBFNet over the LUT's box, 2 x 2 x 2
    regions, written as a config JSON and a weights npz."""
    mid = BOX.mean(1)
    config = dict(
        model_class="WCRBFNet", in_features=3, out_features=5,
        num_kernels=32, num_regions=8, basis_func="gaussian",
        head_mode="per_region", activation_idx=[0, 1, 2],
        lower_bounds=[[lo, m - 0.1 * (hi - lo)] for (lo, hi), m in
                      zip(BOX, mid)],
        upper_bounds=[[m + 0.1 * (hi - lo), hi] for (lo, hi), m in
                      zip(BOX, mid)],
        dimension_ranges=[[a, b, c] for a in range(2) for b in range(2)
                          for c in range(2)],
        delta=[2.0, 2.0, 8.0], input_scale=[0.14, 0.22, 1.1])
    model = from_config(config, device="cpu", seed=23)
    rng = np.random.default_rng(23)
    with torch.no_grad():
        model.centers.copy_(torch.as_tensor(rng.uniform(
            BOX[:, 0], BOX[:, 1], (8, 32, 3)), dtype=torch.float32))
        model.log_sigs.copy_(torch.as_tensor(
            rng.normal(0.0, 0.3, (8, 32)), dtype=torch.float32))
        model.head_kernel.copy_(torch.as_tensor(
            rng.normal(0.0, 1.0, model.head_kernel.shape),
            dtype=torch.float32))
        model.head_bias.copy_(torch.as_tensor(rng.normal(0.0, 1.0, 5),
                                              dtype=torch.float32))
    d = tmp_path_factory.mktemp("small_net")
    save_config(str(d / "net.json"), config)
    npz = save_checkpoint(str(d / "net"), model, step=0)
    return str(d / "net.json"), npz


def test_small_net_against_the_float64_reference(small_net):
    conf, npz = small_net
    model, _ = load_model(conf, npz, device="cpu")
    goals = _grid(13, 11, 9).astype(np.float32)
    got = net_params(model, goals, chunk=256)
    assert got.shape == (goals.shape[0], 5) and got.dtype == np.float32
    want = ref_wcrbf.forward(ref_wcrbf.load_net(conf, npz),
                             torch.as_tensor(goals, dtype=torch.float64))
    assert np.isfinite(got).all()
    assert float(np.abs(want.numpy()).max()) > 0.1  # the heads do act
    assert _gap(got, want) < 2e-5
    # the tolerance sees a forward one precision down
    ctl = ref_wcrbf.forward(ref_wcrbf.load_net(conf, npz, "bf16"),
                            torch.as_tensor(goals))
    assert _gap(ctl.float().numpy(), want) > 2e-5


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_lattice_route_is_the_old_loop_bit_for_bit(small_net, chunk):
    """float64 goals, as ``load_lut`` gives them, at a chunk that does not
    divide N (1,287 rows: one chunk and a tail) and at one over N."""
    model, _ = load_model(*small_net, device="cpu")
    goals = _grid(13, 11, 9)
    before = spans.counters()
    got = net_params(model, goals, chunk=chunk)
    moved = spans.since(before, "lattice.")
    np.testing.assert_array_equal(got, _old_loop(model, goals, chunk))
    n = goals.shape[0]
    assert moved["lattice.rows"] == n
    assert moved["lattice.chunks"] == -(-n // chunk)
    assert moved["lattice.families"] == 1


def test_spans_of_a_traced_pass(small_net):
    """One ``lattice.family`` a pass, one ``lattice.solve`` a chunk."""
    model, _ = load_model(*small_net, device="cpu")
    goals = _grid(13, 11, 9)
    spans.enable(True)
    spans.reset()
    try:
        net_params(model, goals, chunk=500)
        names = [r["name"] for r in spans.records()]
    finally:
        spans.enable(False)
        spans.reset()
    assert names.count("lattice.family") == 1
    assert names.count("lattice.solve") == 3
    assert names.count("lattice.stage") == 3


def test_committed_clothoid_net_against_the_reference():
    """The committed ``clothoid_pr`` at its widths (R=128, K=256, F=3, O=5)
    on 256 goals of the LUT's grid, drawn by a seed, the last goal in."""
    with open(ASSET + ".json") as f:
        conf = json.load(f)
    assert (conf["num_regions"], conf["num_kernels"], conf["in_features"],
            conf["out_features"]) == (128, 256, 3, 5)
    model, _ = load_model(ASSET + ".json", ASSET + ".npz", device="cpu")
    shape = (251, 161, 158)
    n = int(np.prod(shape))
    idx = np.union1d(np.random.default_rng(7).choice(n, 255, replace=False),
                     [n - 1])
    axes = [np.linspace(lo, hi, m) for (lo, hi), m in zip(BOX, shape)]
    goals = np.stack([a[i] for a, i in zip(axes, np.unravel_index(
        idx, shape))], axis=-1).astype(np.float32)
    got = net_params(model, goals, chunk=100)
    net = ref_wcrbf.load_net(ASSET + ".json", ASSET + ".npz")
    want = ref_wcrbf.forward(net, torch.as_tensor(goals, dtype=torch.float64))
    assert np.isfinite(got).all()
    assert _gap(got, want) < 2e-4
