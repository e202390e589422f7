"""simplex_tpu_torch -- the dense revised simplex solver on PyTorch + CUDA.

The port of ``simplex_tpu`` (JAX on a TPU) to one NVIDIA H100: the pivot
loop runs in PyTorch, and its hot ops -- the pricing scan, the fused ratio
test and the rank-1 update of the basis inverse -- run through CUDA kernels
written for Hopper (``simplex_tpu_torch/csrc``). This package never imports
jax; ``simplex_tpu`` stays the reference it is tested against.

    from simplex_tpu_torch import solve, load_lp
    A, b, c = load_lp("tests/data/sample.txt")
    result = solve(A, b, c, device="cuda")      # max c.x s.t. Ax=b, 0<=x(<=u)

    from simplex_tpu_torch import read_mps, solve_general, GeneralLP
    p = read_mps("tests/data/prod_bounded.mps")  # >=/= rows, bounds
    lp = GeneralLP(p.A, p.b, -p.c, p.row_types, p.lower, p.upper)
    result = solve_general(lp, presolve=True, device="cuda")

    from simplex_tpu_torch import SimplexOptions, ranging, reoptimize
    result = solve(A, b, c, options=SimplexOptions(pricing="steepest"))
    rng = ranging(A, b, c, result.basis)         # allowable delta-b / delta-c
    again = reoptimize(A, b_new, c, result)      # dual simplex, warm

    import scipy.sparse as sps                   # sparse A, every entry point
    result = solve(sps.csc_matrix(A), b, c)

    from simplex_tpu_torch import trace_pivots, solve_with_checkpoints
    for rec in trace_pivots(A, b, c): ...        # one record a pivot
    result = solve_with_checkpoints(A, b, c, path="run.npz")  # resumable

    from simplex_tpu_torch import solve_batched, reoptimize_batched
    res = solve_batched(As, bs, cs)              # (B, m, n): B LPs at once
    res = reoptimize_batched(A, bs_new, c, result)  # (B, m) rhs scenarios

    from simplex_tpu_torch import solve_pdhg, crossover
    fo = solve_pdhg(A, b, c, tol=1e-4)           # first-order, inverse-free
    vertex = crossover(A, b, c, fo)              # exact basic optimum

    from simplex_tpu_torch import solve_sharded, solve_sharded_2d  # a process a rank
    from simplex_tpu_torch.dist.mesh import make_mesh
    from simplex_tpu_torch.fo import solve_pdhg_sharded
    mesh = make_mesh()                           # every rank of the group
    result = solve_sharded(A, b, c, mesh)        # A's columns over the ranks
    res = solve_batched(As, bs, cs, mesh=make_mesh(("batch",)))
    mesh2 = make_mesh(("rows", "cols"), shape=(2, 2))
    result = solve_sharded_2d(A, b, c, mesh2)    # B_inv's rows over "rows" too
    fo = solve_pdhg_sharded(A, b, c, mesh)       # first-order, sharded

Modules and subpackages:
    core     state, pivot step (native upper bounds; Dantzig, devex and
             steepest-edge pricing), host-driven solve loop, Newton
             inversion, the dual simplex, the two-phase route, the pivot
             trace, checkpoint / resume
    batch    many same-shape LPs (or rhs scenarios) at once: the batched
             step on three batched Hopper kernels
    dist     the mesh of ranks (torch.distributed: NCCL on the cards,
             gloo on the CPU), the column-sharded solve, the batch split
             over the ranks, the 2-D rows x cols solve and its
             checkpointed solve
    fo       PDHG (PDLP-style first-order solver), column-sharded PDHG and
             crossover
    analysis ranging and the warm re-solve after a rhs change
    sparse   sparse A on the device (CSR of A and of A^T), its ops
    kernels  plain torch ops, the Hopper kernel wrappers and their build
    io       the reference text format, MPS read/write, canonical form
    oracle   instance generators and the HiGHS oracle
"""

from simplex_tpu_torch.analysis import RangingResult, ranging, reoptimize
from simplex_tpu_torch.batch.vmapped import BatchSolveResult, reoptimize_batched, solve_batched
from simplex_tpu_torch.config import DEFAULT_OPTIONS, SimplexOptions
from simplex_tpu_torch.core.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    solve_with_checkpoints,
    validate_checkpoint,
)
from simplex_tpu_torch.core.dual import solve_dual
from simplex_tpu_torch.core.solver import SolveResult, solve
from simplex_tpu_torch.core.state import Problem, SolverState
from simplex_tpu_torch.core.trace import PivotRecord, print_trace, trace_pivots
from simplex_tpu_torch.core.twophase import GeneralLP, GeneralSolveResult, solve_general
from simplex_tpu_torch.dist.sharded import solve_sharded
from simplex_tpu_torch.dist.sharded2d import solve_sharded_2d
from simplex_tpu_torch.fo.crossover import crossover
from simplex_tpu_torch.fo.pdhg import PDHGResult, solve_pdhg
from simplex_tpu_torch.io.mps import read_mps
from simplex_tpu_torch.io.mps_write import write_mps
from simplex_tpu_torch.io.text import dumps_lp, load_lp, loads_lp, save_lp
from simplex_tpu_torch.presolve import postsolve, presolve
from simplex_tpu_torch.sparse import SparseA
from simplex_tpu_torch.status import SolveStatus

__all__ = [
    "BatchSolveResult",
    "DEFAULT_OPTIONS",
    "GeneralLP",
    "GeneralSolveResult",
    "PDHGResult",
    "PivotRecord",
    "Problem",
    "RangingResult",
    "SimplexOptions",
    "SolveResult",
    "SolveStatus",
    "SolverState",
    "SparseA",
    "crossover",
    "dumps_lp",
    "load_checkpoint",
    "load_lp",
    "loads_lp",
    "postsolve",
    "presolve",
    "print_trace",
    "ranging",
    "read_mps",
    "reoptimize",
    "reoptimize_batched",
    "save_checkpoint",
    "save_lp",
    "solve",
    "solve_batched",
    "solve_dual",
    "solve_general",
    "solve_pdhg",
    "solve_sharded",
    "solve_sharded_2d",
    "solve_with_checkpoints",
    "trace_pivots",
    "validate_checkpoint",
    "write_mps",
    "__version__",
]

__version__ = "0.2.0"
