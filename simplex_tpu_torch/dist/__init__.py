"""Distributed modes on ``torch.distributed``: the mesh of ranks
(:mod:`~simplex_tpu_torch.dist.mesh`), the column-sharded solve
(:mod:`~simplex_tpu_torch.dist.sharded`), the 2-D rows x cols solve
(:mod:`~simplex_tpu_torch.dist.sharded2d`) and its chunked, checkpointed
form (:mod:`~simplex_tpu_torch.dist.checkpoint2d`). Sharded PDHG is
:func:`simplex_tpu_torch.fo.solve_pdhg_sharded`; ``python -m
simplex_tpu_torch.dist.dryrun`` runs every mode against HiGHS."""

from simplex_tpu_torch.dist.checkpoint2d import solve_sharded_2d_with_checkpoints
from simplex_tpu_torch.dist.mesh import (
    BATCH_AXIS,
    COLS_AXIS,
    ROWS_AXIS,
    flat_group,
    initialize_multihost,
    make_mesh,
)
from simplex_tpu_torch.dist.sharded import make_collective_backend, solve_sharded
from simplex_tpu_torch.dist.sharded2d import solve_sharded_2d

__all__ = [
    "BATCH_AXIS",
    "COLS_AXIS",
    "ROWS_AXIS",
    "flat_group",
    "initialize_multihost",
    "make_collective_backend",
    "make_mesh",
    "solve_sharded",
    "solve_sharded_2d",
    "solve_sharded_2d_with_checkpoints",
]
