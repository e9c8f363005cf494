"""Parameters on a mesh of ranks and the MoE's expert-parallel paths,
against the reference on the CPU.

The port runs on four gloo ranks, a (data 2, model 2) mesh, once for the
module (``tests/_mesh_ranks.py``, group ``moe``); the reference runs in a
subprocess on four forced host devices (``tests/_mesh_reference.py``).
Cases:

* ``init_tree(..., mesh=)`` gives each rank the slice of the whole init,
  bit for bit, for every smoke config under both rule sets, with the
  default slab and with slabs of 97 elements (whose runs cut rows);
  ``convert.lm_params_from_arrays(..., mesh=)`` gives the same slices.
* ``moe_apply`` on the same weights (carried by ``convert``) and input,
  each rank given its rows of the batch (split over data, as the model
  hands them in every mode) and its output rows gathered whole for the
  comparison: in full expert parallelism (``mode="decode"``, experts
  placed by ``SERVE_RULES``) and in the ``shard_map`` branch
  (``mode="train"``, ``DEFAULT_RULES``: experts over model, D over data),
  every rank's output
  within rtol 1e-5 / atol 1e-6 of the scale of the reference's, and the
  aux equal to the last bit of float32 (the router's mean sums in another
  order, as on the local path). The ``shard_map`` branch reckons capacity
  per data shard, so it drops other assignments than the local path: its
  output must differ from the local path's. A serving prefill past 16,384
  tokens (``mode="prefill"``, ``SERVE_RULES``) takes the ``shard_map``
  branch through its explicit expert reshard; a layer whose E the model
  axis does not divide takes the local branch on the mesh. Both are held
  to the reference in the same way.
* what the mesh must refuse: a world size the mesh does not match, the
  production mesh on four ranks, a collective on a device the backend
  cannot carry, a sharded init without its rules, and a training batch
  (``train_loss``) or microbatch (the train step) that the data axis does
  not divide.
"""
import os

import numpy as np
import pytest

import _mesh_common as mc
import _mesh_ranks as mr
from repro_torch import configs as tcfg

RULES = ("serve", "default")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_moe"))
    out = os.path.join(d, "ref.npz")
    ref = mr.run_reference(out, "moe")
    try:
        ranks = mr.run_ranks("moe", d)
    finally:
        want = mr.finish_reference(ref, out)
    return want, ranks


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_sharded_init_is_the_whole_init_s_slice(runs, arch, rules):
    for res in runs[1]:
        assert res[f"init/{arch}/{rules}"]
        assert res[f"init_slab97/{arch}/{rules}"]
        assert res[f"shard_shapes/{arch}/{rules}"]


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_convert_carries_this_rank_s_slice(runs, arch, rules):
    for res in runs[1]:
        assert res[f"convert/{arch}/{rules}"]


def _held(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", [c[0] for c in mc.MOE_CASES])
def test_full_expert_parallelism_equals_reference(runs, case):
    want, ranks = runs
    for r, res in enumerate(ranks):
        _held(res[f"{case}/decode/y"], want[f"{case}/decode/y"], f"rank {r}")
        np.testing.assert_allclose(res[f"{case}/decode/aux"],
                                   want[f"{case}/decode/aux"],
                                   rtol=2 ** -23, atol=0)
        assert res[f"{case}/decode/moe_full_ep"] == 1
        assert res[f"{case}/decode/moe_shard_map"] == 0


@pytest.mark.parametrize("case", [c[0] for c in mc.MOE_CASES])
def test_shard_map_branch_equals_reference_not_the_local_path(runs, case):
    want, ranks = runs
    y, local = want[f"{case}/train/y"], want[f"{case}/local/y"]
    for r, res in enumerate(ranks):
        _held(res[f"{case}/train/y"], y, f"rank {r}")
        np.testing.assert_allclose(res[f"{case}/train/aux"],
                                   want[f"{case}/train/aux"],
                                   rtol=2 ** -23, atol=0)
        assert res[f"{case}/train/moe_shard_map"] == 1
        assert res[f"{case}/train/moe_full_ep"] == 0
        # capacity per data shard drops other assignments
        got = res[f"{case}/train/y"]
        assert np.abs(got - res[f"{case}/local/y"]).max() > \
            1e-2 * np.abs(local).max()
    assert np.abs(y - local).max() > 1e-2 * np.abs(local).max()


@pytest.mark.parametrize("case", [c[0] for c in mc.MOE_CASES])
def test_long_prefill_reshards_serving_experts_as_reference(runs, case):
    want, ranks = runs
    for r, res in enumerate(ranks):
        _held(res[f"{case}/prefill/y"], want[f"{case}/prefill/y"],
              f"rank {r}")
        np.testing.assert_allclose(res[f"{case}/prefill/aux"],
                                   want[f"{case}/prefill/aux"],
                                   rtol=2 ** -23, atol=0)
        assert res[f"{case}/prefill/moe_shard_map"] == 1
        assert res[f"{case}/prefill/moe_full_ep"] == 0


def test_local_branch_on_the_mesh_equals_reference(runs):
    want, ranks = runs
    for r, res in enumerate(ranks):
        _held(res["local_e5/train/y"], want["local_e5/train/y"], f"rank {r}")
        np.testing.assert_allclose(res["local_e5/train/aux"],
                                   want["local_e5/train/aux"],
                                   rtol=2 ** -23, atol=0)
        assert res["local_e5/train/moe_local"] == 1
        assert res["local_e5/train/moe_shard_map"] == 0


@pytest.mark.parametrize("what", ["world_size", "production_mesh",
                                  "no_collective_for_meta",
                                  "init_without_rules", "train_loss",
                                  "train_step"])
def test_the_mesh_refuses(runs, what):
    for res in runs[1]:
        assert res[f"raises/{what}"]


def test_host_mesh_clamps_to_the_world(runs):
    for res in runs[1]:
        assert res["host_mesh"]
