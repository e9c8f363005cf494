"""Production-mesh dry-run: run one rank's step of every (architecture x
input shape x mesh) cell on fake tensors over a fake process group of 256
or 512 ranks, and keep per-rank memory, FLOPs, bytes and collective bytes
as one JSON record a cell.

The port of the reference's ``repro.launch.dryrun``, which lowers and
compiles each cell with XLA on 512 placeholder host devices and reads the
compiled program. Here nothing is compiled and no card is needed:

* the mesh: :func:`fake_group` joins ``torch.distributed``'s fake backend
  (a ``FakeProcessGroup``, which moves no data), over which
  :func:`repro_torch.launch.mesh.make_production_mesh` lays out (data 16,
  model 16) or (pod 2, data 16, model 16) as rank 0;
* the step: :class:`repro_torch.launch.steps.ArchRunner`'s bundle, its
  arguments made as fake CPU tensors (``FakeTensorMode``; on the CPU,
  ``kernels.ops`` takes its plain versions, so no kernel is handed a fake
  pointer) and the step run once;
* ``memory``: ``argument_bytes`` exactly, from the shard metas, the batch
  (a serving step's rows of it) and a decode step's blocks of the caches
  (the reference's ``cache_specs`` layout, whose bytes a decode record
  also keeps as ``cache_bytes_reference_layout``); ``temp_bytes`` and ``output_bytes`` from
  :class:`Account`, a dispatch mode that tracks the storages the step
  makes (the peak of their live bytes, less the outputs';
  ``alias_bytes``: outputs that are arguments updated in place);
* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``,
  which counts products and attention, not elementwise work (XLA's
  ``flops`` counts both: ROADMAP §3);
* ``bytes_per_device``: every aten op's operand and result bytes (views
  and allocations move none), the unfused upper bound that the
  reference's XLA-CPU ``bytes accessed`` also is;
* collectives: each collective the step ran, by op, result bytes and group
  size (``mesh.records``), through :func:`collective_bytes`, the
  reference's accounting.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Records go to ``artifacts/dryrun_torch/`` (``DRYRUN_TORCH_ARTIFACTS``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import (ALL_SHAPES, ARCH_NAMES, SHAPES_BY_NAME, get_config,
                       supports_shape)
from ..distributed.sharding import NamedSharding
from ..models import params as pr
from .mesh import make_production_mesh
from .steps import ArchRunner, materialize

ARTIFACT_DIR = os.environ.get(
    "DRYRUN_TORCH_ARTIFACTS",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                 "dryrun_torch"))

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

MESH_WORLD = {"single_pod": 256, "multi_pod": 512}


def collective_bytes(records, n_devices: int = 1):
    """Per-rank collective accounting: ``(totals, wire, counts)``, dicts
    over the six HLO collective names, from ``records`` (``mesh.records``:
    (op, result bytes, group size) -> calls, or an iterable of such
    triples; a group size of ``None`` means ``n_devices``).

    The reference's rules (P = the group size): the operand is result/P
    for an all-gather, result·P for a reduce-scatter and the result
    itself otherwise; ``wire`` is the bytes a rank moves on a ring:
    (P-1)/P of the result for an all-gather or all-to-all, 2(P-1)/P for
    an all-reduce, (P-1) results for a reduce-scatter, the result for a
    permute or broadcast."""
    totals = {c: 0 for c in _COLLECTIVES}
    wire = {c: 0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}
    items = (records.items() if isinstance(records, dict)
             else ((r, 1) for r in records))
    for (op, rbytes, P), calls in items:
        P = n_devices if P is None else int(P)
        if op == "all-gather":
            operand = rbytes // max(P, 1)
            w = rbytes * (P - 1) // max(P, 1)
        elif op == "reduce-scatter":
            operand = rbytes * P
            w = rbytes * (P - 1)
        elif op == "all-reduce":
            operand = rbytes
            w = 2 * rbytes * (P - 1) // max(P, 1)
        elif op == "all-to-all":
            operand = rbytes
            w = rbytes * (P - 1) // max(P, 1)
        elif op in _COLLECTIVES:  # collective-permute / broadcast
            operand = rbytes
            w = rbytes
        else:
            raise ValueError(f"unknown collective {op!r}")
        totals[op] += operand * calls
        wire[op] += w * calls
        counts[op] += calls
    return totals, wire, counts


@contextlib.contextmanager
def fake_group(world_size: int):
    """Join ``torch.distributed``'s fake backend as rank 0 of
    ``world_size`` for the block, and leave it after. Refuses
    (``RuntimeError``) inside a process that already has a default group:
    the dry-run tools alone join it, in their own process."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("this process already has a default process "
                           "group; the dry-run joins a fake one of its own "
                           "and runs in a process of its own")
    # registers the "fake" backend (a FakeProcessGroup: no data moves)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")


class Account(TorchDispatchMode):
    """Counts what a block's aten ops touch: ``bytes``, every op's operand
    and result bytes (views, allocations and collectives excluded), and
    the storages the ops make: ``live`` bytes now and their ``peak``.
    Storages that existed before the block (the step's arguments) are not
    counted; one freed during the block leaves ``live``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.made = WeakIdKeyDictionary()
        self.known = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def owns(self, t: torch.Tensor) -> bool:
        """Whether the block made ``t``'s storage."""
        return t.untyped_storage() in self.made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self.made:
                    self.known[st] = True
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.overloadpacket.__name__
        if not (func.is_view or ns in ("c10d", "_c10d_functional")
                or name in _ALLOCATIONS):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self.made and st not in self.known:
                    n = st.nbytes()
                    self.made[st] = n
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)
        return out


def count_step(fn, args) -> dict:
    """Run ``fn(*materialize(args))`` once on fake CPU tensors (no data,
    no card) and count it: ``flops`` (``FlopCounterMode``), ``bytes``,
    ``peak_bytes`` (of the storages the run made), ``output_bytes``
    (outputs it made) and ``alias_bytes`` (outputs that are arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        tensors = materialize(args)
        acc = Account()
        with acc, FlopCounterMode(display=False) as fc:
            out = fn(*tensors)
        outs = {id(t.untyped_storage()): t for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)}
        made = sum(t.untyped_storage().nbytes() for t in outs.values()
                   if acc.owns(t))
        alias = sum(t.untyped_storage().nbytes() for t in outs.values()
                    if not acc.owns(t))
        return {"flops": int(fc.get_total_flops()), "bytes": int(acc.bytes),
                "peak_bytes": int(acc.peak), "output_bytes": int(made),
                "alias_bytes": int(alias)}


def laid_out_bytes(shapes, specs, mesh) -> int:
    """The bytes of a rank's shards of ``shapes`` laid out by ``specs``
    (a spec tree of the same structure) on ``mesh``."""
    sizes = []
    pr.map_tree(lambda s, sp: sizes.append(
        math.prod(NamedSharding(mesh, sp).shard_shape(s.shape))
        * s.dtype.itemsize), shapes, specs)
    return sum(sizes)


def roofline_chunk(seq: int) -> int:
    """The reference roofline's attention chunk for a sequence of ``seq``
    (its ``_measure``): a quarter of it, within [128, 8192]."""
    return max(min(seq // 4, 8192), 128)


def run_cell(arch: str, shape_name: str, mesh_kind: str, artifact_dir: str,
             force: bool = False):
    """One cell's record, written to ``artifact_dir``. Needs the fake
    group of the mesh's world size (:func:`fake_group`,
    :data:`MESH_WORLD`). A cached ``ok`` / ``skipped`` record is returned
    unless ``force``.

    A train or prefill step is counted with :func:`roofline_chunk`'s
    attention chunks (recorded as ``q_chunk`` / ``kv_chunk``): a fake
    step's time grows with the blocks ``flash_attention`` visits, 2,080 a
    layer at 32,768 tokens in the configs' chunks of 512 (11.5 minutes for
    olmo-1b's prefill). A decode step has no chunks."""
    cell_id = f"{arch}__{shape_name}__{mesh_kind}"
    out_path = os.path.join(artifact_dir, cell_id + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("status") in ("ok", "skipped"):
            print(f"[cached ] {cell_id}: {prev['status']}")
            return prev
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = supports_shape(cfg, shape)
    rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "mesh": mesh_kind, "kind": shape.kind}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_path, rec)
        print(f"[skipped] {cell_id}: {why}")
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"),
                                    device="cpu")
        if shape.kind != "decode":
            c = roofline_chunk(shape.seq_len)
            cfg = dataclasses.replace(cfg, q_chunk=c, kv_chunk=c)
            rec.update(q_chunk=c, kv_chunk=c)
        runner = ArchRunner(cfg, mesh)
        bundle = runner.bundle_for(shape)
        arg_bytes = {str(i): 0 if isinstance(a, int) else pr.tree_bytes(a)
                     for i, a in enumerate(bundle.args)}
        counted = count_step(bundle.fn, bundle.args)
        devices = mesh.size
        colls, cwire, ccounts = collective_bytes(mesh.records, devices)
        if shape.kind == "decode":
            rec["cache_bytes_reference_layout"] = laid_out_bytes(
                *runner.decode_cache_layout(shape), mesh)
        rec.update(
            status="ok", step=bundle.name, devices=devices,
            mesh_shape=dict(mesh.shape), run_s=round(time.time() - t0, 2),
            memory={
                "argument_bytes": sum(arg_bytes.values()),
                "argument_bytes_by_arg": arg_bytes,
                "output_bytes": counted["output_bytes"],
                "temp_bytes": max(counted["peak_bytes"]
                                  - counted["output_bytes"], 0),
                "alias_bytes": counted["alias_bytes"],
            },
            flops_per_device=counted["flops"],
            bytes_per_device=counted["bytes"],
            collective_bytes=colls, collective_wire_bytes=cwire,
            collective_counts=ccounts)
        print(f"[ok     ] {cell_id}: {rec['run_s']:.1f}s flops/dev "
              f"{rec['flops_per_device']:.3e}")
    except Exception as e:  # noqa: BLE001 — record failures as artifacts
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERROR  ] {cell_id}: {type(e).__name__}: {e}")
    _write(out_path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", default=None, choices=list(MESH_WORLD))
    ap.add_argument("--artifacts", default=ARTIFACT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(None if argv is None else list(argv))

    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = [args.mesh] if args.mesh else list(MESH_WORLD)

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = supports_shape(get_config(a), SHAPES_BY_NAME[s])
                print(f"{a:24s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0

    results = []
    for m in meshes:
        with fake_group(MESH_WORLD[m]):
            for a in archs:
                for s in shapes:
                    results.append(run_cell(a, s, m, args.artifacts,
                                            force=args.force))
    status = Counter(r["status"] for r in results)
    print(f"\ndry-run summary: {status['ok']} ok, {status['skipped']} "
          f"skipped, {status['error']} errors of {len(results)} cells")
    return 1 if status["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
