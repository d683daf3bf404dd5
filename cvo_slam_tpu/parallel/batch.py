"""Multi-sequence data parallelism: vmapped/sharded CVO alignment batches.

New capability vs the reference (which is strictly single-sequence,
single-thread — SURVEY.md section 2.4): S sequences are tracked in lockstep,
their per-frame CVO alignments batched on the leading axis and sharded over a
device mesh ("dp" axis). The align while_loop runs to the max iteration count
across the batch (per-element convergence masks freeze finished elements —
standard vmap-of-while semantics).
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CvoParams
from ..cvo import engine


def batched_align(fixed: engine.PointCloud, moving: engine.PointCloud,
                  R0, T0, ell0, p: CvoParams, backend: str = "auto"):
    """vmap of engine.align over a leading batch axis."""
    if backend == "auto":
        backend = engine.default_backend()
    fn = jax.vmap(lambda f, m, R, T, e: engine.align(f, m, R, T, e, p,
                                                     backend))
    return fn(fixed, moving, R0, T0, ell0)


def make_sharded_align(mesh: Mesh, p: CvoParams, axis: str = "dp"):
    """Batched align jitted with batch-axis sharding over `mesh`.

    Inputs must have leading dim divisible by mesh.shape[axis]; XLA keeps each
    sequence's alignment resident on one device (no cross-device traffic in
    the hot loop — DP is embarrassingly parallel here)."""
    shard = NamedSharding(mesh, P(axis))

    @partial(jax.jit,
             in_shardings=((shard,) * 3, (shard,) * 3, shard, shard, shard),
             out_shardings=None)
    def fn(fixed, moving, R0, T0, ell0):
        return batched_align(engine.PointCloud(*fixed), engine.PointCloud(*moving),
                             R0, T0, ell0, p)

    return fn
