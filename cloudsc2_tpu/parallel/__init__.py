
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Column-sharded data parallelism over a device mesh.

The reference is single-process (SURVEY.md §2.3: no MPI/NCCL anywhere in the
tree); parallelism is a new capability of this framework.  Columns are
physically independent (every stencil touches only ``[0, 0, ±k]`` offsets,
reference ``physics/nonlinear/_stencils/cloudsc2.py`` passim), so the natural
and only decomposition is columns across devices: a 2-D ``('node',
'device')`` mesh — processes outer, the cards of one host inner — with every
``(nlev, ncols)`` field sharded ``P(None, ('node', 'device'))``.  The
vertical K recurrence stays sequential *inside* each device's kernel; no
halo, no collective in the hot path.  Collectives appear only in validation norms (global sums / maxima
over columns), which XLA lowers to ``psum`` over the mesh.
"""
from cloudsc2_tpu.parallel.mesh import (
    column_mesh,
    column_sharding,
    initialize_distributed,
    pad_columns,
    replicated_sharding,
    shard_state,
    unpad_columns,
)

__all__ = [
    "column_mesh",
    "column_sharding",
    "replicated_sharding",
    "initialize_distributed",
    "pad_columns",
    "shard_state",
    "unpad_columns",
]
