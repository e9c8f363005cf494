"""``ServeEngine(..., mesh=)`` on a mesh of ranks against the reference's
on the CPU, in the reference's serving layout.

Four gloo ranks on a (data 2, model 2) mesh serve each of the ten smoke
configs once for the module (``tests/_mesh_ranks.py``, group ``serve``):
the parameters carried from one numpy tree by
``convert.lm_params_from_arrays(..., mesh=)`` under ``SERVE_RULES``, the
same whole batch on every rank, of which each rank serves its 2 of the 4
rows over its ``cache_specs`` block of every cache leaf (a kv cache's 16
of 32 positions). The reference serves the same tree and batch on four
forced host devices with its parameters placed by ``SERVE_RULES``
(``tests/_mesh_reference.py``). Every rank's greedy tokens equal the
reference's and the port's mesh-less tokens, its last logits within rtol
1e-4 / atol 1e-5 of the scale of both, and all ranks agree bit for bit;
the MoE configs take full expert parallelism. So do a batch of 3, which
the data axis does not divide (replicated), and a max_len of 31, which
the model axis does not divide (kv sequences whole), on four configs.
Each rank's cache blocks after ``seed_caches`` and after a decode step
have the ``cache_specs`` shard shapes, their bytes are
``laid_out_bytes``' reckoning, and gathered back they equal the mesh-less
caches; a decode step's collectives, less the per-unit weight gathers,
carry at most the softmax statistics and partial outputs of rows (a
layer's width a row) and the rank's rows' logits, and do not change with
the caches' length, so no cache leaf crosses ranks. ``pmax`` equals a
whole max. The front-end configs' ``wq`` leaves are scaled by 0.25 on
both sides (ROADMAP §3 (ai)).
"""
import os

import numpy as np
import pytest
import torch

import _mesh_common as mc
import _mesh_ranks as mr
from repro_torch import configs
from repro_torch.models import LM

EDGE = [(a, c) for a in mc.SERVE_EDGE_ARCHS for c in mc.SERVE_EDGE_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_serve"))
    out = os.path.join(d, "ref.npz")
    ref = mr.run_reference(out, "serve")
    try:
        ranks = mr.run_ranks("serve", d)
    finally:
        want = mr.finish_reference(ref, out)
    return want, ranks


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_mesh_tokens_equal_reference(runs, arch):
    want, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"{arch}/tokens"],
                                      want[f"{arch}/tokens"])
        _close(res[f"{arch}/logits"], want[f"{arch}/logits"], f"rank {r}")
    if configs.get_smoke_config(arch).n_experts:
        assert all(res[f"{arch}/moe_full_ep"] > 0 for res in ranks)


@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_mesh_equals_meshless_and_ranks_agree(runs, arch):
    ranks = runs[1]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"{arch}/tokens"],
                                      res[f"{arch}/tokens_meshless"])
        _close(res[f"{arch}/logits"], res[f"{arch}/logits_meshless"],
               f"rank {r}")
        np.testing.assert_array_equal(res[f"{arch}/tokens"],
                                      ranks[0][f"{arch}/tokens"])
        np.testing.assert_array_equal(res[f"{arch}/logits"],
                                      ranks[0][f"{arch}/logits"])
        assert res[f"{arch}/all_gather"] > 0


@pytest.mark.parametrize("arch,case", EDGE)
def test_edge_batches_equal_reference(runs, arch, case):
    """A replicated batch of 3 and a max_len of 31: the reference's tokens,
    the mesh-less run's, equal on every rank."""
    want, ranks = runs
    key = f"{arch}/{case}"
    B = mc.SERVE_EDGE_CASES[case][0]
    for r, res in enumerate(ranks):
        assert res[f"{key}/tokens"].shape == (B, mc.SERVE_NEW)
        np.testing.assert_array_equal(res[f"{key}/tokens"],
                                      want[f"{key}/tokens"])
        np.testing.assert_array_equal(res[f"{key}/tokens"],
                                      res[f"{key}/tokens_meshless"])
        _close(res[f"{key}/logits"], want[f"{key}/logits"], f"rank {r}")
        _close(res[f"{key}/logits"], res[f"{key}/logits_meshless"],
               f"rank {r}")
        np.testing.assert_array_equal(res[f"{key}/logits"],
                                      ranks[0][f"{key}/logits"])


@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_cache_blocks_are_the_reference_layout(runs, arch):
    """After seeding and after a decode step each rank's leaves have the
    ``cache_specs`` shard shapes, and their bytes are the reckoning."""
    for r, res in enumerate(runs[1]):
        c = f"{arch}/cache"
        for when in ("seeded", "stepped"):
            assert res[f"{c}/{when}/shapes_are_blocks"], (r, when)
            assert res[f"{c}/{when}/bytes"] == res[f"{c}/reckoned_bytes"]
    if arch == "olmo-1b":
        # 2 of 4 rows and 16 of 32 positions of each (k, v) leaf
        cfg = configs.get_smoke_config(arch)
        assert runs[1][0][f"{arch}/cache/reckoned_bytes"] == (
            cfg.n_layers * 2 * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4)


@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_cache_blocks_gather_to_the_meshless_caches(runs, arch):
    for r, res in enumerate(runs[1]):
        for when in ("seeded", "stepped"):
            assert res[f"{arch}/cache/{when}/gathered_rel_err"] <= 1e-5, \
                (r, when)


def _attention_layers(arch) -> int:
    """The layers whose decode attends over a cache (self or cross)."""
    lm = LM(configs.get_smoke_config(arch))
    return sum(seg.repeats * ((d.mixer in ("attn", "attn_local", "mla"))
                              + d.cross)
               for seg in lm.layout for d in seg.pattern)


@pytest.mark.parametrize("arch", mc.SERVE_ARCHS)
def test_decode_collectives_carry_no_cache_leaf(runs, arch):
    """Every collective of a decode step but the weight gathers: the
    rank's rows' logits gathered along the vocabulary once, and otherwise
    at most a layer's width a row (softmax statistics, partial outputs,
    the MoE's tokens, RWKV-6's token shift), for at most the batch's rows;
    one ``pmax`` a layer that attends over a cache; and the same
    collectives at a max_len of 64 as at 32."""
    cfg = configs.get_smoke_config(arch)
    width = max(cfg.d_model, cfg.n_heads * cfg.head_dim)
    B_loc = mc.SERVE_B // 2
    for r, res in enumerate(runs[1]):
        log = res[f"{arch}/cache/collectives"]
        op = np.array(mr.COLLECTIVES)[log[:, 0]]
        n_in, n_out, rows, last = log[:, 1], log[:, 2], log[:, 3], log[:, 4]
        vocab = (op == "all_gather") & (last == cfg.vocab)
        assert vocab.sum() == 1 and (rows[vocab] == B_loc).all(), r
        other = ~vocab
        assert (rows[other] <= mc.SERVE_B).all(), (r, log)
        assert (n_in[other] <= width * rows[other]).all(), (r, log)
        assert (n_out[other] <= width * mc.SERVE_B).all(), (r, log)
        assert (op == "pmax").sum() == _attention_layers(arch), (r, log)
        assert res[f"{arch}/cache/collectives_long_equal"], r


def test_pmax_equals_a_whole_max(runs):
    for res in runs[1]:
        np.testing.assert_array_equal(res["pmax"], res["pmax_want"])
        np.testing.assert_array_equal(res["pmax_model"],
                                      res["pmax_model_want"])
        assert res["pmax_backward_raises"]


def test_broadcast_over_one_and_two_axes(runs):
    """``broadcast`` over (data, model) from index 3 and over model from
    index 1: every rank holds the source rank's tensor."""
    draws = [torch.randn(3, 5, generator=torch.Generator().manual_seed(
        50 + r)).numpy() for r in range(4)]
    for r, res in enumerate(runs[1]):
        np.testing.assert_array_equal(res["broadcast_both"], draws[3])
        data = r // 2
        np.testing.assert_array_equal(res["broadcast_model"],
                                      draws[data * 2 + 1])
