"""Carry an index or a model's weights from the JAX reference package
into the port, without importing the reference:

* ``MSTGIndex.load(path)`` reads the reference's ``mstg-index`` v1 ``.npz``
  artifact as it is (the port writes the same format);
* :func:`index_from_arrays` builds a port index from the reference's
  ``FrozenVariant`` arrays handed over as numpy, and optionally its
  quantized store (``QuantizedStore.to_arrays()``), which the port's engine
  then serves as it is, without quantizing again;
* :func:`lm_params_from_arrays` turns the reference LM's parameter tree,
  its leaves handed over as numpy, into the port's LM parameters: the
  layouts are the same, so this is a rename and a copy, never a transpose.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .core import intervals as iv
from .core.api import IndexSpec
from .core.engine import resolve_device
from .core.mstg import _FV_ARRAYS, _INDEX_FORMAT, _INDEX_FORMAT_VERSION, MSTGIndex

_STORE_ARRAYS = ("codes", "code_scale", "code_offset", "code_sq_norm")
_CODE_DTYPES = {np.dtype(np.int8): "int8", np.dtype(np.float16): "float16"}


def index_from_arrays(vectors: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                      variants: Mapping[str, Mapping[str, np.ndarray]],
                      spec: IndexSpec,
                      domain_values: Optional[np.ndarray] = None,
                      storage: Optional[Mapping[str, np.ndarray]] = None
                      ) -> MSTGIndex:
    """A port :class:`MSTGIndex` from numpy arrays.

    ``variants`` maps a variant name (``"T"``, ``"Tp"``, ``"Tpp"``) to the
    arrays of its ``FrozenVariant`` (``sort_rank``, ``tkey``, ``nbr``,
    ``lab_b``, ``lab_e``, ``entry_ids``, ``entry_ver``, ``members``,
    ``member_ver``, ``node_off``). The scalars ``K``, ``Kpad``, ``Lv`` and
    ``n`` may ride along in the same mapping; otherwise they are read off
    the shapes. ``domain_values`` defaults to the domain of ``lo``/``hi``,
    which is what the reference builds unless it was given one.

    ``storage`` carries a quantized store: the arrays of the reference's
    ``QuantizedStore.to_arrays()`` (``codes``, ``code_scale``,
    ``code_offset``, ``code_sq_norm``) and, optionally, its ``dtype``
    (``"int8"`` or ``"float16"``; read off the codes otherwise). The index
    then has that storage tier, whatever ``spec.storage_dtype`` says unless
    it names another quantized tier, which raises ``ValueError``.
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    domain = (iv.AttributeDomain(domain_values) if domain_values is not None
              else iv.AttributeDomain.from_ranges(lo, hi))
    arrays: Dict[str, np.ndarray] = {
        "vectors": np.ascontiguousarray(vectors, np.float32), "lo": lo,
        "hi": hi, "domain_values": domain.values}
    spec_d = spec.to_dict()
    if storage is not None:
        missing = [f for f in _STORE_ARRAYS if f not in storage]
        if missing:
            raise KeyError(f"storage lacks arrays {missing}")
        dtype = storage.get("dtype") or _CODE_DTYPES.get(
            np.asarray(storage["codes"]).dtype)
        if dtype not in ("int8", "float16"):
            raise ValueError(f"storage: no quantized tier for codes of type "
                             f"{np.asarray(storage['codes']).dtype}")
        if spec.storage_dtype not in ("float32", dtype):
            raise ValueError(f"spec.storage_dtype={spec.storage_dtype!r} but "
                             f"the store holds {dtype!r} codes")
        spec_d["storage_dtype"] = dtype
        arrays.update({f: np.asarray(storage[f]) for f in _STORE_ARRAYS})
    meta = {"format": _INDEX_FORMAT, "format_version": _INDEX_FORMAT_VERSION,
            "storage_dtype": spec_d["storage_dtype"], "spec": spec_d,
            "params": {}, "variants": {}}
    for name, fv in variants.items():
        missing = [f for f in _FV_ARRAYS if f not in fv]
        if missing:
            raise KeyError(f"variant {name!r} lacks arrays {missing}")
        nbr = np.asarray(fv["nbr"])
        meta["variants"][name] = {
            "K": int(fv.get("K", domain.K)),
            "Kpad": int(fv.get("Kpad", np.asarray(fv["node_off"]).shape[1] - 1)),
            "Lv": int(fv.get("Lv", nbr.shape[0])),
            "n": int(fv.get("n", nbr.shape[1]))}
        for f in _FV_ARRAYS:
            arrays[f"{name}.{f}"] = np.asarray(fv[f])
    return MSTGIndex.from_payload(arrays, meta, path="<arrays>")


def _flat_paths(tree, prefix=()) -> Dict[tuple, Any]:
    """{(key, ...): leaf} of nested dicts and lists (a list position is an
    int key)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[tuple, Any] = {}
    for k, v in items:
        out.update(_flat_paths(v, prefix + (k,)))
    return out


def _path_key(entry):
    """A key of a ``jax.tree_util`` key path (``DictKey.key``,
    ``SequenceKey.idx``), or a plain str / int key as it is."""
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    return entry


def _host_tensor(a) -> torch.Tensor:
    """A copy of ``a`` as a host tensor (numpy's bfloat16 from
    ``ml_dtypes`` included, which ``torch.from_numpy`` does not take)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_arrays(cfg, tree, device=None):
    """The port's parameter tree for ``LM(cfg)`` from the reference's.

    ``tree`` is the reference's parameter pytree with numpy leaves (nested
    dicts and lists, e.g. ``jax.tree.map(np.asarray, params)``), or the
    ``(key_path, leaf)`` pairs that ``jax.tree_util.tree_flatten_with_path``
    gives. Each leaf is copied to ``device`` (``None`` means ``"cuda"``) in
    the config's parameter dtype. A missing or unknown path raises
    ``KeyError``, a leaf of another shape ``ValueError``. The result goes
    to ``LM.set_params`` or ``ServeEngine(lm, params)``."""
    from .models.transformer import LM
    device = resolve_device(device)
    metas = LM(cfg).abstract_params()
    want = _flat_paths(metas)
    if isinstance(tree, dict):
        have = _flat_paths(tree)
    else:
        have = {tuple(_path_key(e) for e in path): leaf
                for path, leaf in tree}
    name = lambda p: ".".join(str(k) for k in p)
    missing = sorted(name(p) for p in want if p not in have)
    unknown = sorted(name(p) for p in have if p not in want)
    if missing or unknown:
        raise KeyError(f"lm_params_from_arrays({cfg.name!r}): missing "
                       f"{missing}, unknown {unknown}")
    out = {}
    for path, m in want.items():
        t = _host_tensor(have[path])
        if tuple(t.shape) != m.shape:
            raise ValueError(f"{name(path)}: shape {tuple(t.shape)}, "
                             f"{cfg.name} needs {m.shape}")
        out[path] = t.to(device=device, dtype=m.dtype)

    def build(t, prefix=()):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(t)]
        return out[prefix]

    return build(metas)
