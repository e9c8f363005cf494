"""The port's dry-run tools on fake ranks (``repro_torch.launch.dryrun``,
``steps``, ``dryrun_mstg``) and the collectives' byte records.

The fake process group is a process-wide default group, so everything
that joins it runs once in a subprocess (``tests/_dryrun_ranks.py``, as
``tests/test_system.py`` runs the reference's dry-run), which writes its
numbers as JSON; the mesh-less count below runs in this process. Bars:
the bundles run (``ok``), count FLOPs and collectives, and are handed the
metas' bytes; the count at full depth is the count at one repeat a
segment plus (R_k - 1) units, exactly; the MSTG step's counted FLOPs are
the model's 2·Q_loc·N_loc·d; a fake count equals a count on real tensors.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import count_step
from repro_torch.models import LM
from repro_torch.models.params import map_tree
from repro_torch.models.transformer import ShapeDtype
from repro_torch.training import AdamWConfig, adamw_init, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ranks.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_dryrun_ranks.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_bundles_run_on_a_fake_mesh(ranks, kind):
    rec = ranks[kind]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["temp"] > 0
    assert sum(rec["counts"].values()) > 0
    assert rec["counts"]["all-gather"] > 0


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_argument_bytes_are_the_shard_metas_and_the_batch(ranks, kind):
    """A rank is handed its shards (a quarter of olmo-1b smoke under
    DEFAULT_RULES' FSDP x TP on (2, 2, 2), half under SERVE_RULES' TP);
    in training the whole batch, in decode its rows of the tokens (2 of 8:
    the batch over pod and data) and its blocks of the caches (its rows,
    32 of 64 positions: the sequence over model), the bytes the
    reference's layout reckons."""
    rec = ranks[kind]
    args = rec["arg_bytes"]
    assert args[0] == rec["shard_bytes"] < rec["whole_bytes"]
    B, S = 8, 64
    if kind == "train":
        # m and v in float32 (the parameters are float32 too) and the step
        assert args[1] == 2 * rec["shard_bytes"] + 4
        assert args[2] == 2 * B * S * 4             # tokens and labels
    else:
        B_loc, S_loc = B // 4, S // 2
        assert args[2] == B_loc * 4 and args[3] == 0  # tokens, position
        cfg = get_smoke_config("olmo-1b")
        assert args[1] == rec["cache_reckoned"] == (
            2 * cfg.n_layers * B_loc * S_loc * cfg.n_kv_heads
            * cfg.head_dim * 4)


@pytest.mark.parametrize("case", ["recurrentgemma-2b|train",
                                  "recurrentgemma-2b|decode",
                                  "deepseek-v3-671b|train",
                                  "deepseek-v3-671b|decode"])
def test_full_depth_count_is_one_repeat_plus_units(ranks, case):
    """The identity the reference's scan correction assumes holds for the
    port's count exactly (it counts every repeat)."""
    v = ranks["identity"][case]
    assert max(v["repeats"]) > 1
    units = [b - v["base"] for b in v["bumps"]]
    assert all(u > 0 for u in units)
    assert v["full"] == v["base"] + sum(
        (R - 1) * u for R, u in zip(v["repeats"], units))


@pytest.mark.parametrize("merge", ["all_gather", "tournament",
                                   "fullmesh_v2"])
def test_mstg_step_merges_and_counts_the_model_flops(ranks, merge):
    rec = ranks["mstg"][merge]
    assert rec["out"] == [[rec["q_loc"], 10], "torch.int32",
                          [rec["q_loc"], 10]]
    assert rec["flops"] == rec["model"] == 2 * rec["q_loc"] * \
        rec["n_loc"] * 16
    # on the (2, 2, 2) mesh: one all_gather of ids and one of distances an
    # axis merged by all_gather, and two ppermutes (ids, distances) a
    # tournament round, one round an axis of 2, as the reference's HLO
    gathered = {"all_gather": 2, "tournament": 1, "fullmesh_v2": 0}[merge]
    permuted = {"all_gather": 0, "tournament": 1, "fullmesh_v2": 3}[merge]
    assert rec["counts"]["all-gather"] == 2 * gathered
    assert rec["counts"]["collective-permute"] == 2 * permuted


def test_fake_group_refuses_a_second_group(ranks):
    assert ranks["nested_group_refused"]


def test_production_cell_record(ranks):
    rec = ranks["cell"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 256 and rec["mesh_shape"] == {"data": 16,
                                                          "model": 16}
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(mem["argument_bytes_by_arg"].values())
    # a rank's blocks of the caches, the reference's layout, updated in
    # place: olmo-1b's (16 layers, k and v) of 8 of 128 rows and 2,048 of
    # 32,768 positions, 16 kv heads of 128 in bfloat16
    assert mem["alias_bytes"] == mem["argument_bytes_by_arg"]["1"]
    assert rec["cache_bytes_reference_layout"] == \
        mem["argument_bytes_by_arg"]["1"] == 2_147_483_648
    assert mem["argument_bytes_by_arg"]["2"] == 8 * 4     # its rows' tokens
    for key in ("flops_per_device", "bytes_per_device"):
        assert rec[key] > 0
    assert rec["collective_counts"]["all-gather"] > 0


def test_fake_count_equals_a_count_on_real_tensors():
    """The mesh-less smoke train step counted on fake tensors and on real
    CPU tensors: the same FLOPs, an exact integer."""
    from torch.utils.flop_counter import FlopCounterMode
    lm = LM(get_smoke_config("olmo-1b"))
    step = make_train_step(lm, AdamWConfig())
    params = lm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, lm.cfg.vocab, (4, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        step(params, adamw_init(params), {"tokens": toks, "labels": toks})
    real = fc.get_total_flops()

    def shapes(dtype=None):
        return map_tree(lambda m: ShapeDtype(m.shape, dtype or m.dtype),
                        lm.abstract_params())

    tok = ShapeDtype((4, 32), torch.int32)
    args = (shapes(), {"m": shapes(torch.float32),
                       "v": shapes(torch.float32),
                       "step": ShapeDtype((), torch.int32)},
            {"tokens": tok, "labels": tok})
    assert isinstance(real, int) and real > 0
    assert count_step(step, args)["flops"] == real
