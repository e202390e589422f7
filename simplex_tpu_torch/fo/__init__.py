"""First-order LP solvers (PDHG, PDLP-style): the inverse-free mode, on one
card and column-sharded over a mesh of ranks."""

from simplex_tpu_torch.fo.pdhg import PDHGResult, solve_pdhg
from simplex_tpu_torch.fo.sharded import solve_pdhg_sharded

__all__ = ["PDHGResult", "solve_pdhg", "solve_pdhg_sharded"]
