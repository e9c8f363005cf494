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
  layouts are the same, so this is a rename and a copy, never a transpose;
  :func:`opt_state_from_arrays` does the same for the reference's AdamW
  state ``{"m", "v", "step"}``;
* :func:`arrays_from_tree` goes the other way: a port parameter tree or
  optimizer state as numpy leaves in the reference's tree, ready for
  ``jax.tree.map(jnp.asarray, ...)``.
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


def _carry(cfg, tree, device, dtype=None, mesh=None, rules=None):
    """The port's tree in ``LM(cfg)``'s parameter layout from the
    reference's (see :func:`lm_params_from_arrays`), each leaf in
    ``dtype`` or, for ``None``, its parameter's dtype; with ``mesh``, this
    rank's shard of each leaf under ``rules``."""
    from .distributed.sharding import NamedSharding
    from .models.params import spec_for
    from .models.transformer import LM
    if mesh is not None and rules is None:
        raise ValueError("carrying parameters onto a mesh needs its rules "
                         "(SERVE_RULES or DEFAULT_RULES)")
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
        raise KeyError(f"{cfg.name}: missing "
                       f"{missing}, unknown {unknown}")
    out = {}
    for path, m in want.items():
        a = np.asarray(have[path])
        if tuple(a.shape) != m.shape:
            raise ValueError(f"{name(path)}: shape {tuple(a.shape)}, "
                             f"{cfg.name} needs {m.shape}")
        if mesh is not None:
            a = a[NamedSharding(mesh, spec_for(m, mesh, rules)).index(
                m.shape)]
        out[path] = _host_tensor(a).to(device=device,
                                       dtype=dtype or m.dtype)

    def build(t, prefix=()):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(t)]
        return out[prefix]

    return build(metas)


def lm_params_from_arrays(cfg, tree, device=None, *, mesh=None, rules=None):
    """The port's parameter tree for ``LM(cfg)`` from the reference's.

    ``tree`` is the reference's parameter pytree with numpy leaves (nested
    dicts and lists, e.g. ``jax.tree.map(np.asarray, params)``), or the
    ``(key_path, leaf)`` pairs that ``jax.tree_util.tree_flatten_with_path``
    gives. Each leaf is copied to ``device`` (``None`` means ``"cuda"``) in
    the config's parameter dtype. A missing or unknown path raises
    ``KeyError``, a leaf of another shape ``ValueError``. The result goes
    to ``LM.set_params`` or ``ServeEngine(lm, params)``.

    With ``mesh`` (a mesh of ranks) each leaf is this rank's slice of the
    reference's under ``rules``, which a mesh requires (``ValueError``
    without; see :func:`repro_torch.models.params.sharding_tree`); under
    ``SERVE_RULES`` it is the tree ``ServeEngine(lm, params, mesh=mesh)``
    takes."""
    return _carry(cfg, tree, device, mesh=mesh, rules=rules)


def opt_state_from_arrays(cfg, state, device=None, *, mesh=None,
                          rules=None):
    """The port's AdamW state (:func:`repro_torch.training.adamw_init`'s
    layout) for ``LM(cfg)`` from the reference's ``{"m", "v", "step"}``
    with numpy leaves: ``m`` and ``v`` carried as
    :func:`lm_params_from_arrays` carries a parameter tree, in float32
    (with ``mesh``, this rank's slices under ``rules``, the parameters'
    layout); ``step`` an int32 scalar, whole."""
    dev = resolve_device(device)
    kw = dict(mesh=mesh, rules=rules)
    return {"m": _carry(cfg, state["m"], dev, torch.float32, **kw),
            "v": _carry(cfg, state["v"], dev, torch.float32, **kw),
            "step": _host_tensor(state["step"]).to(device=dev,
                                                   dtype=torch.int32)}


def arrays_from_tree(tree):
    """A port tree (parameters, an optimizer state, gradients) as the
    reference's tree with numpy leaves: dicts and lists kept, each tensor
    copied to the host. numpy has no bfloat16 of its own, so a bfloat16
    leaf comes back as float32, which holds it exactly."""
    if isinstance(tree, dict):
        return {k: arrays_from_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [arrays_from_tree(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()
