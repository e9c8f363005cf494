"""The port's training loss against the reference's for deepseek-v3-671b's
smoke config: MLA in training mode, the MoE's load-balance aux and the
multi-token-prediction loss, with the helpers and tolerances of
``test_torch_train_loss.py``.
"""
import numpy as np

from test_torch_train_loss import (assert_train_loss_equal_reference,
                                   port_lm, reference_case, to_torch)
from test_torch_train_loss import one_torch_thread  # noqa: F401 (autouse)


def test_train_loss_and_grads_equal_reference():
    assert_train_loss_equal_reference("deepseek-v3-671b")


def test_mtp_and_aux_enter_the_loss():
    """loss = xent + 0.3 mtp + 0.01 aux, and the ``mtp`` block's leaves
    get gradients (but its MoE's routing bias, which only picks
    experts)."""
    from repro_torch.models.params import leaves
    from repro_torch.training import loss_and_grads
    _, _, _, params, batch = reference_case("deepseek-v3-671b")
    lm = port_lm("deepseek-v3-671b", params)
    loss, met, grads = loss_and_grads(lm, lm.params, to_torch(batch))
    assert float(met["mtp"]) > 0 and float(met["aux"]) > 0
    np.testing.assert_allclose(
        float(loss), float(met["xent"]) + 0.3 * float(met["mtp"])
        + 0.01 * float(met["aux"]), rtol=1e-6)
    g_mtp = dict(grads["mtp"], layer=dict(grads["mtp"]["layer"]))
    g_mtp["layer"]["mlp"] = {k: v for k, v in g_mtp["layer"]["mlp"].items()
                             if k != "bias"}
    mtp = leaves(g_mtp)
    assert mtp and all(float(g.abs().max()) > 0 for g in mtp)
