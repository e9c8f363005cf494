"""Training on a mesh of ranks against the reference on the CPU.

The port runs on four gloo ranks, a (data 2, model 2) mesh, once for the
module (``tests/_mesh_ranks.py``, group ``train``); the reference runs in
a subprocess on four forced host devices (``tests/_mesh_reference.py``):
``jax.value_and_grad(lm.train_loss)`` with the parameters placed by
``DEFAULT_RULES`` and the batch by ``batch_spec``, and one step of its
``make_train_step(lm, mesh=mesh)`` from one AdamW state two steps in
(``_mesh_common.train_opt_state``, carried by
``convert.opt_state_from_arrays(..., mesh=)``). Both sides take the same
numpy weights (``_mesh_common.train_weights``: the leaves of
``TRAIN_CONDITIONING`` scaled, as ``tests/test_torch_train_loss.py``
scales them, and the MoE router widened so that routing is decisive) and
the same global batch of 4 x 16 tokens. Cases:

* for the dense (olmo-1b), MoE (qwen3-moe-30b-a3b: the ``shard_map``
  branch, its capacity reckoned per batch shard at a capacity factor of
  1.0, the aux ``pmean``'d over the shards), encoder
  (seamless-m4t-large-v2), multi-token-prediction (deepseek-v3-671b: MLA
  and the MoE too) and vision-stub (llava-next-mistral-7b) smoke configs:
  the loss and its metrics within
  1e-5 relative, and every rank's shard of every gradient leaf, and of
  every parameter, ``m`` and ``v`` leaf after one AdamW step, within rtol
  1e-4 and atol 1e-5 of the leaf's scale of the slice of the reference's
  (``tests/test_torch_train_loss.py``'s tolerances); ``grad_norm`` within
  1e-5;
* the collectives' backward rules on float64 tensors against their
  gradients worked out by hand (1e-12): an all-gather over a batch axis
  (summed and scattered), over a replicated axis (sliced), a psum feeding
  replicated work (passed through), the router ahead of the experts' psum
  (summed over model), ``pmean`` and ``psum_scatter``;
* ``compressed_grad_sync`` over ``data``, eight error-feedback syncs of
  one gradient a data rank, against the reference's inside ``shard_map``
  (rtol 1e-6 and atol 1e-6 of the gradients' scale);
* two microbatches of the global batch against one on the mesh (the
  reference's microbatch tolerances);
* a bfloat16 training state saved from the (2, 2) mesh restores on (4,
  1), (2, 2), (1, 1) and without a mesh, bit-equal to the slice of the
  whole state; ``TrainLoop`` on the mesh, 2 steps, a save, a restore and 2
  more, equals 4 straight bit for bit.

The reference's mesh gradients equal its own mesh-less ones up to
summation order (ROADMAP §3, reference caveats); the MoE's aux on a mesh
is the mean of the batch shards' auxes in both packages.
"""
import os

import numpy as np
import pytest

import _mesh_common as mc
import _mesh_ranks as mr
from test_torch_models import _close
from test_torch_training import _state_close

LOSS_RTOL = 1e-5
RULES = ("all_gather_batch_axis", "all_gather_replicated_axis",
         "unshard_model_data", "psum_feeds_replicated",
         "router_ahead_of_psum", "pmean", "psum_scatter",
         "psum_scatter_grad")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_train"))
    out = os.path.join(d, "ref.npz")
    ref = mr.run_reference(out, "train")
    try:
        ranks = mr.run_ranks("train", d)
    finally:
        want = mr.finish_reference(ref, out)
    return want, ranks


def _slice(whole, box):
    return whole[tuple(slice(a, b) for a, b in box)]


def _leaf_count(res, key):
    return sum(1 for k in res if k.startswith(key))


@pytest.mark.parametrize("arch", mc.TRAIN_ARCHS)
def test_mesh_loss_and_every_gradient_equal_reference(runs, arch):
    want, ranks = runs
    n = _leaf_count(want, f"{arch}/grad/")
    assert n > 0
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{arch}/loss"], want[f"{arch}/loss"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        keys = sorted(k for k in want if k.startswith(f"{arch}/metric/"))
        assert keys == sorted(k for k in res
                              if k.startswith(f"{arch}/metric/"))
        for k in (k.rsplit("/", 1)[1] for k in keys):
            np.testing.assert_allclose(res[f"{arch}/metric/{k}"],
                                       want[f"{arch}/metric/{k}"],
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
        assert _leaf_count(res, f"{arch}/grad/") == n
        for i in range(n):
            _close(res[f"{arch}/grad/{i}"],
                   _slice(want[f"{arch}/grad/{i}"], res[f"{arch}/box/{i}"]),
                   f"{arch} rank {r} grad leaf {i}")
        assert res[f"{arch}/counts/psum_scatter"] > 0
        assert res[f"{arch}/serve_layout_refused"]
    if arch == "qwen3-moe-30b-a3b":
        assert all(res[f"{arch}/counts/moe_shard_map"] > 0 for res in ranks)
        assert float(want[f"{arch}/metric/aux"]) > 0


@pytest.mark.parametrize("arch", mc.TRAIN_ARCHS)
def test_mesh_adamw_step_equals_reference(runs, arch):
    want, ranks = runs
    for r, res in enumerate(ranks):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"{arch}/step/{k}"],
                                       want[f"{arch}/step/{k}"],
                                       rtol=LOSS_RTOL, err_msg=f"rank {r} {k}")
        for part in ("params", "m", "v"):
            n = _leaf_count(want, f"{arch}/step/{part}/")
            assert n == _leaf_count(res, f"{arch}/step/{part}/") > 0
            for i in range(n):
                _close(res[f"{arch}/step/{part}/{i}"],
                       _slice(want[f"{arch}/step/{part}/{i}"],
                              res[f"{arch}/box/{i}"]),
                       f"{arch} rank {r} {part} leaf {i}")


@pytest.mark.parametrize("rule", RULES)
def test_collective_backward_rules(runs, rule):
    for r, res in enumerate(runs[1]):
        assert res[f"rule/{rule}"] <= 1e-12, (r, float(res[f"rule/{rule}"]))


def test_compressed_mean_over_data_equals_reference_shard_map(runs):
    """rtol 1e-6 and atol 1e-6 of the gradients' scale: a residual is a
    difference of values up to max |g| (3.9 here, float32 spacing 2.4e-7)
    carried from sync to sync, and the two packages average the ranks'
    scales in another order."""
    want, ranks = runs
    scale = max(float(np.abs(mc.compressed_input(d)).max()) for d in (0, 1))
    for r, res in enumerate(ranks):
        d = r // mc.MESH_SHAPE[1]
        for i in range(mc.COMPRESSED_STEPS):
            for part in ("mean", "residual"):
                np.testing.assert_allclose(
                    res[f"compressed/{part}/{i}"],
                    want[f"compressed/{part}/{i}"][d], rtol=1e-6,
                    atol=1e-6 * scale, err_msg=f"rank {r} sync {i} {part}")
    # the mean is the same on every rank
    for res in ranks:
        np.testing.assert_array_equal(res["compressed/mean/0"],
                                      ranks[0]["compressed/mean/0"])


def test_mesh_microbatches_equal_one_batch(runs):
    for r, res in enumerate(runs[1]):
        n = _leaf_count(res, "micro1/params/")
        assert n == _leaf_count(res, "micro2/params/") > 0
        for i in range(n):
            np.testing.assert_allclose(res[f"micro2/params/{i}"],
                                       res[f"micro1/params/{i}"],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r} leaf {i}")
        np.testing.assert_allclose(res["micro2/grad_norm"],
                                   res["micro1/grad_norm"], rtol=1e-5)
        for part in ("m", "v"):
            _state_close([res[f"micro2/{part}/{i}"] for i in range(n)],
                         [res[f"micro1/{part}/{i}"] for i in range(n)],
                         1e-5, f"rank {r} microbatches {part}")


@pytest.mark.parametrize("where", ["4x1", "2x2", "1x1", "no_mesh"])
def test_elastic_checkpoint_restores_each_rank_s_slice(runs, where):
    for res in runs[1]:
        assert res["elastic/bf16"]
        assert res[f"elastic/{where}"]


def test_train_loop_on_the_mesh_resumes_bit_equal(runs):
    for res in runs[1]:
        assert int(res["resume/at"]) == 2
        assert res["resume/losses"]
        assert res["resume/state"]
