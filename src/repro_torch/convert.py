"""Carry an index from the JAX reference package into the port.

Two ways, both without importing the reference:

* ``MSTGIndex.load(path)`` reads the reference's ``mstg-index`` v1 ``.npz``
  artifact as it is (the port writes the same format);
* :func:`index_from_arrays` builds a port index from the reference's
  ``FrozenVariant`` arrays handed over as numpy.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from .core import intervals as iv
from .core.api import IndexSpec
from .core.mstg import _FV_ARRAYS, _INDEX_FORMAT, _INDEX_FORMAT_VERSION, MSTGIndex


def index_from_arrays(vectors: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                      variants: Mapping[str, Mapping[str, np.ndarray]],
                      spec: IndexSpec,
                      domain_values: Optional[np.ndarray] = None) -> MSTGIndex:
    """A port :class:`MSTGIndex` from numpy arrays.

    ``variants`` maps a variant name (``"T"``, ``"Tp"``, ``"Tpp"``) to the
    arrays of its ``FrozenVariant`` (``sort_rank``, ``tkey``, ``nbr``,
    ``lab_b``, ``lab_e``, ``entry_ids``, ``entry_ver``, ``members``,
    ``member_ver``, ``node_off``). The scalars ``K``, ``Kpad``, ``Lv`` and
    ``n`` may ride along in the same mapping; otherwise they are read off
    the shapes. ``domain_values`` defaults to the domain of ``lo``/``hi``,
    which is what the reference builds unless it was given one.
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    domain = (iv.AttributeDomain(domain_values) if domain_values is not None
              else iv.AttributeDomain.from_ranges(lo, hi))
    arrays: Dict[str, np.ndarray] = {
        "vectors": np.ascontiguousarray(vectors, np.float32), "lo": lo,
        "hi": hi, "domain_values": domain.values}
    meta = {"format": _INDEX_FORMAT, "format_version": _INDEX_FORMAT_VERSION,
            "storage_dtype": spec.storage_dtype, "spec": spec.to_dict(),
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
