"""The port's training loss against the reference's for the front-end
smoke configs (seamless-m4t-large-v2: the encoder in training mode and
cross-attention over its output; llava-next-mistral-7b: the projected
patches and their -1 labels), with the helpers and tolerances of
``test_torch_train_loss.py``.
"""
import pytest

from test_torch_train_loss import (assert_train_loss_equal_reference,
                                   port_lm, ref_batch, ref_params,
                                   to_torch)
from test_torch_train_loss import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_reference(arch):
    assert_train_loss_equal_reference(arch)


def test_vision_patches_take_no_label():
    """llava's loss scores the tokens only: the patches' positions take
    label -1, so ``tokens`` counts B x S."""
    rlm, params = ref_params("llava-next-mistral-7b")
    batch = to_torch(ref_batch(rlm.cfg))
    lm = port_lm("llava-next-mistral-7b", params)
    _, met = lm.train_loss(None, batch)
    assert batch["patches"].shape[1] == lm.cfg.n_frontend_tokens > 0
    assert float(met["tokens"]) == batch["tokens"].numel()


def test_encoder_gets_gradients_through_cross_attention():
    """seamless's encoder is trained through the decoder's cross-attention:
    every encoder leaf and ``frontend_proj`` get a gradient."""
    from repro_torch.models.params import leaves
    from repro_torch.training import loss_and_grads
    rlm, params = ref_params("seamless-m4t-large-v2")
    lm = port_lm("seamless-m4t-large-v2", params)
    _, _, grads = loss_and_grads(lm, lm.params, to_torch(ref_batch(rlm.cfg)))
    enc = leaves(grads["encoder"]) + leaves(grads["frontend_proj"])
    assert enc and all(float(g.abs().max()) > 0 for g in enc)
