"""The port's (data, expert) mesh (``irbfn_tpu_torch/parallel/mesh.py``)
vs the JAX package's.

On four gloo ranks (one spawn): the mesh shapes and each rank's
coordinates for expert in {1, 2, 4}, the ranks of its two groups, its rows
of a batch, and the error when ``expert`` does not divide the world. In the
test process: a world of one without a process group, and the sharding
rule for every class with a region core (``tests/test_expert_parallel.py::
test_variant_param_trees_get_sharded``): ``centers`` and ``log_sigs`` on
``EXPERT_AXIS``, the rest replicated, and a shard of R / E regions.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from irbfn_tpu import models as jmodels
from irbfn_tpu.parallel.mesh import make_mesh as jmake_mesh
from irbfn_tpu.parallel.mesh import wcrbf_param_sharding as jsharding
from irbfn_tpu_torch import models as tmodels
from irbfn_tpu_torch.parallel import launch, mesh as M, rank_checks

torch.set_num_threads(1)

WORLD = 4
GEOMETRY = dict(
    in_features=8, out_features=10, num_kernels=16, basis_func="gaussian",
    num_regions=8, lower_bounds=[[-2.0, 0.0], [1.0, 4.0], [-1.0, 0.0]],
    upper_bounds=[[0.0, 2.0], [4.0, 7.0], [0.0, 1.0]],
    dimension_ranges=[[i, j, k] for i in range(2) for j in range(2)
                      for k in range(2)],
    activation_idx=[0, 2, 6], delta=[15.0, 100.0, 10.0])
CONFIGS = {
    "WCRBFNet": dict(GEOMETRY, model_class="WCRBFNet",
                     head_mode="per_region"),
    "DeeperWCRBFNet": dict(GEOMETRY, model_class="DeeperWCRBFNet"),
    "ClusterWCRBFNet": dict(in_features=8, out_features=10, num_kernels=16,
                            basis_func="gaussian", num_regions=8,
                            model_class="ClusterWCRBFNet"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = [("mesh", e) for e in (1, 2, 4, 3)]
    return launch.spawn(rank_checks.run_jobs, WORLD, "cpu", jobs,
                        store_dir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("expert", [1, 2, 4])
def test_torch_mesh_shapes_and_groups(ranks, expert):
    i = [1, 2, 4].index(expert)
    jmesh = jmake_mesh(jax.devices()[:WORLD], expert=expert)
    devices = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, res in enumerate(r[i] for r in ranks):
        assert res["shape"] == {M.DATA_AXIS: WORLD // expert,
                                M.EXPERT_AXIS: expert}
        assert res["shape"] == dict(jmesh.shape)
        d, e = res["data_rank"], res["expert_rank"]
        assert (d, e) == divmod(rank, expert)
        # the ranks of each group are the devices along that axis of
        # JAX's mesh, in order
        assert res["data_group"] == [int(v) for v in devices[:, e]]
        assert res["expert_group"] == [int(v) for v in devices[d]]
        n = 8 // (WORLD // expert)
        np.testing.assert_array_equal(res["rows"],
                                      np.arange(d * n, (d + 1) * n))


def test_torch_mesh_expert_must_divide(ranks):
    msg = "expert axis 3 must divide device count 4"
    with pytest.raises(ValueError, match=msg):
        jmake_mesh(jax.devices()[:WORLD], expert=3)
    assert all(r[3] == {"error": msg} for r in ranks)
    with pytest.raises(ValueError, match="expert axis 2 must divide device "
                       "count 1"):
        M.make_mesh(expert=2, device="cpu")


def test_torch_mesh_world_of_one():
    mesh = M.make_mesh(device="cpu")
    assert mesh.shape == {M.DATA_AXIS: 1, M.EXPERT_AXIS: 1}
    assert (mesh.size, mesh.rank, mesh.group()) == (1, 0, None)
    x = torch.arange(6)
    np.testing.assert_array_equal(M.data_sharding(mesh)(x), x)
    assert M.replicated(mesh)(x) is x
    with pytest.raises(ValueError, match="a mesh of 2 ranks"):
        M.make_mesh(2, device="cpu")


def test_torch_data_sharding_needs_even_batches():
    mesh = M.Mesh(torch.device("cpu"), {M.DATA_AXIS: 4, M.EXPERT_AXIS: 2},
                  rank=5)
    np.testing.assert_array_equal(M.data_sharding(mesh)(torch.arange(8)),
                                  [4, 5])
    with pytest.raises(ValueError, match="does not split evenly"):
        M.data_sharding(mesh)(torch.arange(6))


@pytest.mark.parametrize("cls", list(CONFIGS))
@pytest.mark.parametrize("expert", [2, 4, 8])
def test_torch_param_sharding_of_every_core_class(cls, expert):
    config = CONFIGS[cls]
    jmodel = jmodels.from_config(config)
    variables = jmodel.init(jax.random.PRNGKey(1), np.ones((2, 8)))
    jspecs = jsharding(jmake_mesh(jax.devices()[:8], expert=expert))(
        variables)
    model = tmodels.from_config(config, device="cpu", seed=0)
    mesh = M.Mesh(torch.device("cpu"), {M.DATA_AXIS: 8 // expert,
                                        M.EXPERT_AXIS: expert},
                  rank=expert - 1)
    specs = M.wcrbf_param_sharding(mesh)(model)
    params = dict(model.named_parameters())
    assert set(params) <= set(specs)
    for name, spec in specs.items():
        if name in ("centers", "log_sigs"):
            assert spec == M.SHARDED == (M.EXPERT_AXIS,)
            assert jspecs["params"]["core"][name].spec == P(M.EXPERT_AXIS)
        else:
            assert spec == M.REPLICATED, name
    other = [k for k in variables["params"] if k != "core"]
    assert other
    for k in other:
        assert all(s.spec == P() for s in jax.tree.leaves(
            jspecs["params"][k], is_leaf=lambda s: hasattr(s, "spec")))

    # the last rank of the expert group holds the last R / E regions
    sharded = M.shard_params(model, mesh)
    n = 8 // expert
    assert sharded.region_range() == (8 - n, 8)
    assert sharded.centers.shape == (n, 16, 8)
    assert sharded.log_sigs.shape == (n, 16)
    torch.testing.assert_close(sharded.centers, model.centers[8 - n:],
                               rtol=0, atol=0)
    assert model.centers.shape == (8, 16, 8)  # the original stays whole
    for name, p in sharded.named_parameters():
        if name not in ("centers", "log_sigs"):
            torch.testing.assert_close(p, params[name], rtol=0, atol=0)
    with pytest.raises(ValueError, match="already sharded"):
        M.shard_params(sharded, mesh)


def test_torch_mlp_has_no_core():
    model = tmodels.MLP(8, 10, 16, device="cpu", seed=0)
    mesh = M.Mesh(torch.device("cpu"), {M.DATA_AXIS: 1, M.EXPERT_AXIS: 2},
                  rank=1)
    assert set(M.wcrbf_param_sharding(mesh)(model).values()) == {
        M.REPLICATED}
    assert M.shard_params(model, mesh).expert_shard is None
