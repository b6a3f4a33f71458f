"""On the card: the committed ``clothoid_pr`` net (R=128, K=256, F=3, O=5)
over its whole 6,384,938-goal LUT grid through
``eval_lut_accuracy.net_params``, on the lattice chunk loop in 2^18-row
chunks and a 93,482-row tail: bit for bit the loop it replaced; the
kernel's counters (``ops.rbf.rows`` the grid's rows, one forward a chunk);
one ``ops.rbf`` span a chunk while tracing, each labelled with its launch
plan; and the kernel against the benchmark's float64 reference
(``benchmark/reference/wcrbf.py``) on rows drawn from the grid.

Imports no JAX, so that it runs where the card is:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lut_card.py``
(``tests/conftest.py`` sets JAX up for the CPU tests). Without a card the
tests skip."""

import numpy as np
import pytest
import torch

from benchmark.reference import wcrbf as ref_wcrbf
from irbfn_tpu_torch.parallel.datagen import CLOTHOID_GRID, build_lattice
from irbfn_tpu_torch.train import load_model
from irbfn_tpu_torch.train.eval_lut_accuracy import net_params
from irbfn_tpu_torch.utils import spans

ASSET = "irbfn_tpu_torch/assets/clothoid_pr"
CHUNK = 1 << 18
N = 251 * 161 * 158
CHUNKS = -(-N // CHUNK)  # 24 whole chunks and a 93,482-row tail
# |p - p_ref| / (1 + |p_ref|): the kernel sums the basis and the heads in
# float32 over 32,896 terms in its own order; over 21 runs of the
# benchmark cell on an H100 it stood at most 6.7e-5 from float64 (the
# plain float32 version 3.6e-5 on the CPU, tests/test_torch_lut_pass.py),
# so 1e-3 leaves fifteen times the room, well under the cell's limit of
# 0.02 for the same number, which the bfloat16 control (3.9 and more)
# fails
TOL = 1e-3


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def lut(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = load_model(ASSET + ".json", ASSET + ".npz", device=cuda)
    return model.eval(), build_lattice(CLOTHOID_GRID)


def _old_loop(model, goals: np.ndarray, chunk: int) -> np.ndarray:
    """The loop ``net_params`` had before the lattice chunk loop: a
    pageable copy in, the forward, a blocking copy back, a chunk at a
    time."""
    dev = next(model.parameters()).device
    out = np.empty((goals.shape[0], model.out_features), np.float32)
    with torch.no_grad():
        for i0 in range(0, goals.shape[0], chunk):
            x = torch.as_tensor(goals[i0:i0 + chunk], dtype=torch.float32,
                                device=dev)
            out[i0:i0 + chunk] = model(x).cpu().numpy()
    return out


def test_the_pass_is_the_old_loop_bit_for_bit(lut):
    model, goals = lut
    assert goals.shape[0] == N
    before = spans.counters()
    got = net_params(model, goals, CHUNK)
    moved = spans.since(before)
    np.testing.assert_array_equal(got, _old_loop(model, goals, CHUNK))
    assert moved["ops.rbf.rows"] == N == moved["lattice.rows"]
    assert moved["ops.rbf.forwards"] == CHUNKS == moved["lattice.chunks"]
    assert moved["ops.rbf.region_groups"] == CHUNKS  # 128 regions a block


def test_one_rbf_span_a_chunk_while_tracing(lut):
    model, goals = lut
    spans.enable(True)
    spans.reset()
    try:
        net_params(model, goals, CHUNK)
        recs = spans.records()
    finally:
        spans.enable(False)
        spans.reset()
    rbf = [r for r in recs if r["name"] == "ops.rbf"]
    assert len(rbf) == CHUNKS
    assert {r["label"] for r in rbf} == {"128x2"}
    assert [r["chunk"] for r in rbf] == list(range(CHUNKS))
    assert all(recs[r["parent"]]["name"] == "lattice.solve" for r in rbf)


def test_kernel_against_the_float64_reference(lut):
    model, goals = lut
    got = net_params(model, goals, CHUNK)
    idx = np.union1d(np.random.default_rng(23).choice(N, 4095,
                                                      replace=False),
                     [N - 1])
    net = ref_wcrbf.load_net(ASSET + ".json", ASSET + ".npz", "f64", "cuda")
    want = ref_wcrbf.forward(net, torch.as_tensor(goals[idx], device="cuda",
                                                  dtype=torch.float64),
                             block=1024).cpu().numpy()
    assert np.isfinite(got).all()
    gap = np.abs(got[idx] - want) / (1.0 + np.abs(want))
    assert float(gap.max()) < TOL
