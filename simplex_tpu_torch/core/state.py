"""Problem and solver state.

Mutable dataclasses of tensors in place of the JAX package's NamedTuple
pytrees. Leaves for an m x n problem:

  B_inv      (m, m)  explicit basis inverse, product-form maintained
  x_b        (m,)    basic values (B x_b = b)
  y          (m,)    simplex multipliers (y = c_b B_inv)
  c_b        (m,)    costs of the basic columns
  basis      (m,)    column index of each basic variable (int32)
  iters      ()      pivots taken (int32)
  status     ()      SolveStatus code (int32)
  degen      ()      consecutive degenerate pivots (int32)
  last_refac ()      pivot count at the last exact inverse (int32)
  pert               the rhs perturbation, or None when it is off

Scalars stay 0-d device tensors so a pivot step never waits on the host.
The pivot step updates ``B_inv`` in place (the rank-1 update); every other
leaf of the state it returns is a new tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus


@dataclasses.dataclass
class Problem:
    """A canonical-form LP: maximize c.x  s.t.  A x = b, x >= 0."""

    A: torch.Tensor  # (m, n)
    b: torch.Tensor  # (m,)
    c: torch.Tensor  # (n,)


@dataclasses.dataclass
class PertState:
    """The anti-degeneracy rhs shift: x_b solves B x_b = b + w exactly while
    ``on``; ``rounds`` counts activations."""

    w: torch.Tensor  # (m,)
    on: torch.Tensor  # () bool
    rounds: torch.Tensor  # () int32


@dataclasses.dataclass
class SolverState:
    B_inv: torch.Tensor
    x_b: torch.Tensor
    y: torch.Tensor
    c_b: torch.Tensor
    basis: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    degen: torch.Tensor
    last_refac: torch.Tensor
    pert: Optional[PertState] = None


def _int(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _pert_extras(m: int, dtype, device, perturb: bool) -> Optional[PertState]:
    if not perturb:
        return None
    return PertState(
        w=torch.zeros(m, dtype=dtype, device=device),
        on=torch.zeros((), dtype=torch.bool, device=device),
        rounds=_int(0, device),
    )


def initial_state_slack(prob: Problem, dtype, perturb: bool = False) -> SolverState:
    """The trailing-identity slack basis: B_inv = I, x_b = b, y = c_b =
    c[n-m:], basis = [n-m, ..., n-1]."""
    m, n = prob.A.shape
    dev = prob.A.device
    c_b = prob.c[n - m :].to(dtype).clone()
    return SolverState(
        B_inv=torch.eye(m, dtype=dtype, device=dev),
        x_b=prob.b.to(dtype).clone(),
        y=c_b.clone(),
        c_b=c_b,
        basis=torch.arange(n - m, n, dtype=torch.int32, device=dev),
        iters=_int(0, dev),
        status=_int(SolveStatus.RUNNING, dev),
        degen=_int(0, dev),
        last_refac=_int(0, dev),
        pert=_pert_extras(m, dtype, dev, perturb),
    )


def initial_state(
    prob: Problem, basis0, dtype, perturb: bool = False
) -> SolverState:
    """Starting state for a given feasible basis: B_inv by one dense solve
    (an O(m^3) set-up cost), x_b = B_inv b, y = c_b B_inv."""
    m, _ = prob.A.shape
    dev = prob.A.device
    basis = torch.as_tensor(np.asarray(basis0), dtype=torch.int32, device=dev)
    B = _ops.gather_basis_matrix(prob.A, basis).to(dtype)
    B_inv = torch.linalg.solve(B, torch.eye(m, dtype=dtype, device=dev)).contiguous()
    c_b = prob.c.index_select(0, basis).to(dtype)
    return SolverState(
        B_inv=B_inv,
        x_b=B_inv @ prob.b.to(dtype),
        y=c_b @ B_inv,
        c_b=c_b,
        basis=basis,
        iters=_int(0, dev),
        status=_int(SolveStatus.RUNNING, dev),
        degen=_int(0, dev),
        last_refac=_int(0, dev),
        pert=_pert_extras(m, dtype, dev, perturb),
    )


def problem_from_numpy(A, b, c, device, dtype=torch.float32) -> Problem:
    """A Problem on ``device`` from host arrays (or tensors), cast to
    ``dtype``."""

    def put(v):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()

    return Problem(A=put(A), b=put(b), c=put(c))


_LEAVES = ("B_inv", "x_b", "y", "c_b", "basis")
_SCALARS = ("iters", "status", "degen", "last_refac")


def state_from_numpy(leaves: Mapping[str, object], device) -> SolverState:
    """The port's state from host arrays, such as a ``simplex_tpu`` solver
    state's leaves (``{f: np.asarray(getattr(s, f))}``), so both packages
    can start from one mid-solve state.

    ``leaves["pert"]`` is None or the (w, on, rounds) triple. Leaves of
    options outside this port (devex weights, deferred-update buffers) are
    ignored; their values are the JAX package's dummies on this path.
    """
    st = {}
    for f in _LEAVES:
        t = torch.as_tensor(np.array(leaves[f]), device=device)
        st[f] = t.to(torch.int32) if f == "basis" else t.contiguous()
    for f in _SCALARS:
        st[f] = torch.as_tensor(np.array(leaves[f]), device=device).to(torch.int32).reshape(())
    pert = leaves.get("pert")
    if pert is not None:
        w, on, rounds = (np.array(v) for v in pert)
        pert = PertState(
            w=torch.as_tensor(w, device=device),
            on=torch.as_tensor(on, device=device).to(torch.bool).reshape(()),
            rounds=torch.as_tensor(rounds, device=device).to(torch.int32).reshape(()),
        )
    return SolverState(**st, pert=pert)
