"""Atomic, asynchronous checkpoints of tensor trees.

The port of the reference's ``repro.checkpoint.checkpointer``, in its
layout, so a checkpoint written by either package restores in the other:
``<dir>/step_<N>/`` holds one ``.npy`` per leaf, named by the leaf's path
(``params/segments/0/L0/mixer/wq`` is written as
``params__segments__0__L0__mixer__wq.npy``; dict keys in sorted order, as
jax flattens a dict) and a ``manifest.json`` with each leaf's name, file,
shape and dtype, the step and extra metadata (a data cursor). A write goes
to ``step_<N>.tmp`` and is renamed only after the manifest is fsync'd, so
a torn write never shadows the previous checkpoint; the last ``keep``
steps are kept. ``save`` copies every leaf to the host before its writer
thread starts (``async_write``), so the caller may update the tensors at
once; ``wait()`` joins the writer, and a save waits for the one before.

numpy has no bfloat16 of its own: a bfloat16 leaf is written as its raw
2-byte words (``.npy`` type ``V2``, what ``np.save`` writes for an
``ml_dtypes`` bfloat16 array) with ``"dtype": "bfloat16"`` in the
manifest, and read back through the manifest as those bits.

A state sharded over a mesh of ranks is saved whole: ``save(...,
mesh=, specs=)`` all-gathers each leaf from the ranks' shards (every rank
calls it), the rank at the mesh's origin writes, and every rank returns
once the step is published, so a checkpoint does not depend on the mesh it
was written from. ``restore(..., mesh=, specs=)`` (the reference's
``shardings=``, its elastic restore) gives each rank its box of every leaf
on the mesh it runs on now, of any shape; a logical mesh
(:func:`repro_torch.launch.make_mesh`) whose axes all have one shard
restores the whole leaves.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) of every leaf of nested dicts, lists and tuples, in
    jax's order (dict keys sorted); a name joins the keys with ``/``."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix.replace(" ", "_"), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _unflatten(tree, values: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, values, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return values[prefix.replace(" ", "_")]


class _Spec:
    """A spec as a leaf (a spec is a tuple, which a tree walk enters)."""
    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


def _specs_by_name(tree, specs) -> Dict[str, Any]:
    """Each leaf's spec in ``specs`` (a tree of specs matching ``tree``),
    by the leaf's name."""
    from ..models.params import map_tree    # (the core imports this module)
    boxed = map_tree(lambda _, sp: _Spec(sp), tree, specs)
    return {name: b.spec for name, b in _flatten_with_paths(boxed)}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy as numpy, the manifest's dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_file(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ----
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, *,
             mesh=None, specs=None) -> str:
        """Write ``tree`` as step ``step``; returns its directory (written
        once :meth:`wait` returns). With ``mesh`` (a mesh of ranks, every
        one of which calls this) ``tree`` holds this rank's shards laid out
        by ``specs`` (a matching tree of specs): each leaf is gathered
        whole, the rank at the mesh's origin writes them, and every rank
        returns once the step is published."""
        self.wait()
        if mesh is not None:
            return self._save_sharded(step, tree, extra, mesh, specs)
        host = [(name, *_to_host(leaf))
                for name, leaf in _flatten_with_paths(tree)]
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, extra or {})
        return self.step_dir(step)

    def _save_sharded(self, step, tree, extra, mesh, specs) -> str:
        from ..distributed import collectives as coll
        writer = coll.axis_index(mesh, tuple(mesh.shape)) == 0
        spec = _specs_by_name(tree, specs)
        host = []
        with torch.no_grad():
            for name, leaf in _flatten_with_paths(tree):
                whole = coll.unshard(leaf, spec[name], mesh)
                if writer:
                    host.append((name, *_to_host(whole)))
        if writer:
            self._write(step, host, extra or {})
        # every rank returns once the step is on disk
        coll.psum(torch.zeros(1, device=mesh.device), mesh,
                  tuple(mesh.shape))
        return self.step_dir(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, host, extra: Dict) -> None:
        final = self.step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for name, leaf, dtype in host:
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), leaf)
            manifest["leaves"].append({"name": name, "file": fn,
                                       "shape": list(leaf.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ---- restore ----
    def list_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, example_tree: Any, step: Optional[int] = None, *,
                mesh=None, specs=None):
        """(tree, step, extra). ``example_tree`` gives the structure and the
        leaf names; each leaf comes back as a tensor on the device of the
        example's tensor at its path (the CPU where the example has none).
        ``step``: the latest by default. With ``mesh`` and ``specs`` (a
        tree of specs matching ``example_tree``), each leaf is this rank's
        box of the saved whole leaf on ``mesh`` (the reference's elastic
        restore onto the current mesh)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        spec = _specs_by_name(example_tree, specs) if mesh is not None \
            else {}
        values = {}
        for name, ex in _flatten_with_paths(example_tree):
            info = by_name[name]
            t = _from_file(os.path.join(d, info["file"]), info["dtype"])
            if mesh is not None:
                from ..distributed.sharding import NamedSharding
                t = t[NamedSharding(mesh, spec[name]).index(t.shape)]
                t = t.contiguous()
            values[name] = t.to(ex.device if torch.is_tensor(ex) else "cpu")
        return _unflatten(example_tree, values), step, manifest["extra"]
