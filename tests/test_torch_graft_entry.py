"""The port's compile-check and multi-device dry-run entry points
(``irbfn_tpu_torch/graft_entry.py``), the counterparts of
``tests/test_graft_entry.py``'s calls of ``__graft_entry__.py``.

``entry`` on the CPU gives the flagship's (1024, 10) forward, finite, and
the fused op's plain version equals the module path. ``dryrun_multichip(8,
device="cpu")`` runs the DP x EP step on a 4 x 2 mesh of gloo ranks, then
the sharded goal family and the sharded Frenet NMPC lattice; an odd count
runs the step on a mesh of expert 1. With no device named the dry run is
for the cards, and on a host without them it raises rather than running
on the CPU.
"""

import numpy as np
import pytest
import torch

from irbfn_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_torch_entry_runs_the_flagship_forward():
    forward, args = graft_entry.entry(device="cpu")
    model, x = args
    out = forward(*args)
    assert out.shape == (1024, 10)
    assert bool(torch.isfinite(out).all())
    assert model.num_regions == 8 and model.num_kernels == 128
    with torch.enable_grad():
        module = model(x)
    np.testing.assert_allclose(out.numpy(), module.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_torch_dryrun_multichip_8(capsys):
    res = graft_entry.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'data': 4, 'expert': 2}" in line
    assert np.isfinite(res["loss"])
    assert res["nmpc_lattice_rows"] == 16
    assert 0.0 <= res["goal_mpc_conv"] <= 1.0


def test_torch_dryrun_multichip_odd_count(capsys):
    res = graft_entry.dryrun_multichip(3, workload="train_step",
                                       device="cpu")
    assert res["mesh"] == {"data": 3, "expert": 1}
    assert "(train_step only)" in capsys.readouterr().out


def test_torch_dryrun_multichip_needs_the_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"{n + 2} ranks on CUDA need "
                       f"{n + 2} cards; {n} visible"):
        graft_entry.dryrun_multichip(n + 2)
