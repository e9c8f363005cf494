"""Carry an index from the JAX reference package into the port.

Two ways, both without importing the reference:

* ``MSTGIndex.load(path)`` reads the reference's ``mstg-index`` v1 ``.npz``
  artifact as it is (the port writes the same format);
* :func:`index_from_arrays` builds a port index from the reference's
  ``FrozenVariant`` arrays handed over as numpy, and optionally its
  quantized store (``QuantizedStore.to_arrays()``), which the port's engine
  then serves as it is, without quantizing again.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from .core import intervals as iv
from .core.api import IndexSpec
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
