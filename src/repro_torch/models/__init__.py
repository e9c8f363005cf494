"""The port's language model: the dense decoder LM of the reference's
``repro.models`` (attention and MLP layers), as plain torch functions under
an ``nn.Module`` that holds the parameters at the reference's tree paths."""
from .transformer import LM, make_segments, layer_descs
from . import params

__all__ = ["LM", "make_segments", "layer_descs", "params"]
