"""``ServeEngine(..., mesh=)`` on a mesh of ranks against the reference's
on the CPU.

Four gloo ranks on a (data 2, model 2) mesh serve each of the ten smoke
configs once for the module (``tests/_mesh_ranks.py``, group ``serve``):
the parameters carried from one numpy tree by
``convert.lm_params_from_arrays(..., mesh=)`` under ``SERVE_RULES``, the
same whole batch on every rank. The reference serves the same tree and
batch on four forced host devices with its parameters placed by
``SERVE_RULES`` (``tests/_mesh_reference.py``). Every rank's greedy
tokens equal the reference's and the port's mesh-less tokens, its last
logits within rtol 1e-4 / atol 1e-5 of the scale of both, and all ranks
agree bit for bit; the MoE configs take full expert parallelism. The
front-end configs' ``wq`` leaves are scaled by 0.25 on both sides (ROADMAP
§3 (ai)).
"""
import os

import numpy as np
import pytest

import _mesh_common as mc
import _mesh_ranks as mr


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
    from repro_torch import configs
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
