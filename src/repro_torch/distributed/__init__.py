"""Distributed pieces of the port.

Sharded retrieval on one device: logical corpus shards, the merge
schedules over a stacked shard axis, heartbeat-based fault handling.

    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.launch import make_mesh

    mesh = make_mesh((4,), ("data",), device="cuda")
    dep = ShardedDeployment.flat(vectors, lo, hi, mesh=mesh,
                                 spec=DeploymentSpec(n_shards=4,
                                                     merge="tournament"))
    result = dep.execute(SearchRequest(...))   # result.report.shards

A model over a mesh of ranks (``repro_torch.launch.make_rank_mesh``, one
process a rank): :mod:`.collectives` (the reference's named-axis ``psum``,
``pmean``, ``all_gather``, ``psum_scatter`` and ``axis_index``, with the
backward rules training needs) and :mod:`.sharding` (its spec helpers,
``batch_rows`` and ``NamedSharding``), which ``ServeEngine(mesh=)``,
``LM.train_loss(mesh=)``, ``make_train_step(mesh=)`` and the model's
expert-parallel paths run on.
"""
from .topk import (sharded_flat_topk, sharded_topk_merge,
                   tournament_topk_merge, global_topk_merge,
                   MERGE_SCHEDULES, resolve_merge)
from .fault import HeartbeatRegistry
from .deployment import DeploymentSpec, ShardedDeployment

__all__ = ["sharded_flat_topk", "sharded_topk_merge",
           "tournament_topk_merge", "global_topk_merge", "MERGE_SCHEDULES",
           "resolve_merge", "HeartbeatRegistry", "DeploymentSpec",
           "ShardedDeployment"]
