"""The port's training loss against the reference's for the recurrent
smoke configs (recurrentgemma-2b: RG-LRU and local attention; rwkv6-7b:
the RWKV-6 chunk scan), with the helpers and tolerances of
``test_torch_train_loss.py``; and the control behind its
``CONDITIONING``. MLA is in ``test_torch_train_loss_mla.py``, the
front-end configs in ``test_torch_train_loss_front.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import params as tparams
from repro_torch.training import loss_and_grads

from test_torch_train_loss import (assert_train_loss_equal_reference,
                                   port_lm, ref_batch, ref_params,
                                   to_torch)
from test_torch_train_loss import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("recurrentgemma-2b", "rwkv6-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_reference(arch):
    assert_train_loss_equal_reference(arch)


def _grad_moved_over_tolerance(lm, batch, seed: int) -> float:
    """How far a 1e-7 relative change of every weight moves the port's
    own float32 gradients, in units of the parity tolerance (rtol 1e-4,
    atol 1e-5 of the leaf's scale); the worst leaf."""
    gen = torch.Generator().manual_seed(seed)
    moved = tparams.map_tree(
        lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)),
        lm.params)
    _, _, g0 = loss_and_grads(lm, lm.params, batch)
    _, _, g1 = loss_and_grads(lm, moved, batch)
    worst = 0.0
    for a, b in zip(tparams.leaves(g1), tparams.leaves(g0)):
        tol = 1e-4 * b.abs() + 1e-5 * max(1.0, float(b.abs().max()))
        worst = max(worst, float(((a - b).abs() / tol).max()))
    return worst


@pytest.mark.parametrize("arch", ["olmo-1b", "llava-next-mistral-7b",
                                  "rwkv6-7b"])
def test_grad_parity_weights_keep_rounding_inside_the_tolerance(arch):
    """The control behind ``CONDITIONING``: on the weights the parity tests
    carry, a 1e-7 relative change of every weight moves the gradients by
    less than the tolerance; on the reference's init as drawn, by more,
    so a comparison there would measure float32 rounding, not the port."""
    rlm, tamed = ref_params(arch)
    _, raw = ref_params(arch, scales={})
    batch = to_torch(ref_batch(rlm.cfg))
    assert _grad_moved_over_tolerance(port_lm(arch, tamed), batch, 0) < 1.0
    assert _grad_moved_over_tolerance(port_lm(arch, raw), batch, 0) > 1.0
