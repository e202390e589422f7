"""Checkpoint and resume for long solves: ``simplex_tpu.core.checkpoint`` on
the port, plus the light basis snapshots of
``simplex_tpu.dist.checkpoint2d``.

The solve runs in chunks of ``options.checkpoint_every`` pivots (1024 when
0), the same host loop as ``solve`` with a snapshot written between chunks.
A snapshot is one ``.npz`` in the JAX package's format, so a file written
by either package resumes in the other:

  full   B_inv, x_b, y, c_b, basis, iters, status, degen, last_refac, e,
         gamma, U, R, npend (and at_upper on a bounded solve)
  light  the same without B_inv, U and R, plus ``_defer_shape``; written
         when m >= 2048. Resume rebuilds the inverse from the basis.

Where the port's state carries None (e and gamma under the Dantzig rule,
U, R and npend under eager updates), the file holds the JAX package's
dummies: e zeros (1,), gamma ones (1,), U and R zeros (1, 1), npend 0.
Pending deferred pairs are folded into B_inv before a full save, so the
file always holds the true inverse and npend = 0.

Resume validates the snapshot (basis in range and unique, x_b >= -tol,
A_B x_b = b), rebuilds a light snapshot's inverse by a float64 LU on the
device, refactorizes a full snapshot whose inverse has drifted
(``last_refac < iters``), and fits the state to the options it resumes
under (pending-pair buffers, devex / steepest-edge leaves, the candidate
buffer and the perturbation record, none of which a snapshot carries).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import (
    DEFAULT_OPTIONS,
    SimplexOptions,
    check_supported,
    pin_full_fp32,
)
from simplex_tpu_torch.core.solver import (
    SolveResult,
    build_problem,
    finalize_result,
    solve_state,
)
from simplex_tpu_torch.core.state import (
    SolverState,
    _cand_extras,
    _defer_extras,
    _pert_extras,
    _pricing_extras,
    initial_state,
    initial_state_slack,
)
from simplex_tpu_torch.core.step import perturb_clear, recompute_xy, refactorize
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.logging import fields, get_logger
from simplex_tpu_torch.status import SolveStatus

_log = get_logger("checkpoint")

_FIELDS = (
    "B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen",
    "last_refac", "e", "gamma", "U", "R", "npend",
)
_LIGHT_SKIP = ("B_inv", "U", "R")
_INTS = ("basis", "iters", "status", "degen", "last_refac", "npend")

# a light snapshot from m rows up (simplex_tpu.core.checkpoint)
LIGHT_FROM_M = 2048


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def save_checkpoint(path, state: SolverState, light: bool = False) -> None:
    """Write ``state`` to ``path`` (see the module docstring for the
    format). ``light=True`` leaves out B_inv, U and R: the basis and the
    O(m) / O(n) leaves determine the solve, and resume rebuilds the
    inverse. The state is not changed."""
    np_dtype = _host(state.x_b[:0]).dtype
    arrays = {}
    if state.U is not None:
        L, m = state.U.shape
    else:
        L = m = 1
    if not light:
        B_inv = state.B_inv
        if state.U is not None:
            # the true inverse: pending pairs folded in
            B_inv = torch.addmm(B_inv, state.U.T, state.R)
        arrays["B_inv"] = _host(B_inv)
        arrays["U"] = np.zeros((L, m), np_dtype)
        arrays["R"] = np.zeros((L, m), np_dtype)
    else:
        arrays["_defer_shape"] = np.asarray((L, m), np.int64)
    for f in ("x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac"):
        arrays[f] = _host(getattr(state, f))
    # pending pairs are folded (full) or rebuilt away (light)
    arrays["npend"] = np.int32(0)
    if state.e is not None:
        arrays["e"], arrays["gamma"] = _host(state.e), _host(state.gamma)
    else:
        arrays["e"] = np.zeros(1, np_dtype)
        arrays["gamma"] = np.ones(1, np_dtype)
    if state.at_upper is not None:
        arrays["at_upper"] = _host(state.at_upper)
    # a file object: np.savez(path) would append '.npz' to a bare name
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _basis_cols64(A, basis: np.ndarray, device) -> torch.Tensor:
    """A[:, basis] in float64 on ``device``, from a host copy when there is
    one (numpy, scipy, a SparseA's host CSC)."""
    if _sp.is_sparse(A):
        host = A.host if isinstance(A, _sp.SparseA) else A.tocsc()
        return torch.as_tensor(host[:, basis].toarray(), device=device).double()
    if isinstance(A, torch.Tensor):
        return A.index_select(1, torch.as_tensor(basis, device=A.device)).double().to(device)
    return torch.as_tensor(np.asarray(A, np.float64)[:, basis], device=device)


def _yA64(A, y64: np.ndarray) -> np.ndarray:
    """y . A in float64 on the host."""
    if _sp.is_sparse(A):
        host = A.host if isinstance(A, _sp.SparseA) else A.tocsc()
        return np.asarray(y64 @ host, np.float64).ravel()
    if isinstance(A, torch.Tensor):
        return (torch.as_tensor(y64, device=A.device) @ A.double()).cpu().numpy()
    return y64 @ np.asarray(A, np.float64)


def load_checkpoint(path, A=None, b=None, c=None, device="cuda") -> SolverState:
    """Read a snapshot into the port's state on ``device``. A light one
    needs ``A`` to rebuild the inverse (float64 LU on ``device``, cast to
    the snapshot's dtype) and y = c_b B_inv; given ``b`` (and no at-upper
    flags) x_b is re-derived too, given ``c`` the devex / steepest-edge
    reduced costs. The JAX package's dummy leaves come back as None."""
    device = torch.device(device)

    def put(v):
        if isinstance(v, torch.Tensor):
            return v.contiguous()
        return torch.as_tensor(np.ascontiguousarray(v), device=device)

    with np.load(path) as data:
        st = {f: np.array(data[f]) for f in _FIELDS if f in data.files}
        at_upper = np.array(data["at_upper"]) if "at_upper" in data.files else None
        defer_shape = tuple(int(x) for x in data["_defer_shape"]) if "_defer_shape" in data.files else None
    m = st["x_b"].shape[0]
    n = None if A is None else A.shape[1]
    real_e = st["e"].shape[0] == n if n is not None else st["e"].shape[0] > 1
    if "B_inv" not in st:
        if A is None:
            raise ValueError(
                "light checkpoint (no B_inv): pass A to load_checkpoint so the "
                "basis inverse can be rebuilt"
            )
        np_dtype = st["x_b"].dtype
        B64 = _basis_cols64(A, st["basis"].astype(np.int64), device)
        B_inv64 = torch.linalg.inv(B64)
        y64 = (torch.as_tensor(st["c_b"], device=device).double() @ B_inv64).cpu().numpy()
        st["B_inv"] = B_inv64.to(torch.from_numpy(st["x_b"]).dtype)
        st["y"] = y64.astype(np_dtype)
        if b is not None and at_upper is None:
            # the true basic solution, never clamped
            b64 = torch.as_tensor(np.asarray(b, np.float64), device=device)
            st["x_b"] = (B_inv64 @ b64).cpu().numpy().astype(np_dtype)
        if c is not None and real_e:
            st["e"] = (_yA64(A, y64) - np.asarray(c, np.float64)).astype(np_dtype)
        st["last_refac"] = st["iters"]
        st["U"] = st["R"] = np.zeros(defer_shape, np_dtype)
        st["npend"] = np.int32(0)
    leaves = {f: put(st[f]) for f in _FIELDS}
    for f in _INTS:
        leaves[f] = leaves[f].to(torch.int32)
    for f in ("iters", "status", "degen", "last_refac", "npend"):
        leaves[f] = leaves[f].reshape(())
    L, mu = leaves["U"].shape
    if mu != m or ((L, mu) == (1, 1) and m != 1):  # the JAX dummies
        leaves["U"] = leaves["R"] = leaves["npend"] = None
    else:
        leaves["U"], leaves["R"] = leaves["U"].contiguous(), leaves["R"].contiguous()
    if not real_e:
        leaves["e"] = leaves["gamma"] = None
    return SolverState(
        **leaves, at_upper=None if at_upper is None else put(at_upper).to(torch.bool)
    )


def validate_checkpoint(state: SolverState, A, b, tol: float = 1e-3) -> None:
    """Fail fast on a corrupt or mismatched snapshot before resuming."""
    m, n = A.shape
    basis = _host(state.basis).astype(np.int64)
    if tuple(state.B_inv.shape) != (m, m):
        raise ValueError(f"checkpoint B_inv shape {tuple(state.B_inv.shape)} != problem ({m}, {m})")
    if basis.min() < 0 or basis.max() >= n:
        raise ValueError("checkpoint basis indices out of range")
    if len(np.unique(basis)) != m:
        raise ValueError("checkpoint basis has duplicate columns")
    x_b = _host(state.x_b).astype(np.float64)
    if np.any(x_b < -tol):
        raise ValueError("checkpoint primal values are infeasible")
    b = np.asarray(b, np.float64)
    resid = _basis_cols64(A, basis, "cpu").numpy() @ x_b - b
    scale = max(1.0, float(np.abs(b).max()))
    if np.abs(resid).max() > tol * scale:
        raise ValueError(
            f"checkpoint does not satisfy A_B x_b = b (residual {np.abs(resid).max():.2e})"
        )


def save_light_snapshot(path, basis, iters, degen, status) -> None:
    """The basis and three counters, which determine the solve
    (``simplex_tpu.dist.checkpoint2d``'s snapshot for the 2-D mesh)."""
    with open(path, "wb") as f:
        np.savez(
            f,
            basis=np.asarray(basis, np.int32),
            iters=np.int32(iters),
            degen=np.int32(degen),
            status=np.int32(status),
        )


def load_light_snapshot(path, m: int, n: int):
    """Read and validate a light snapshot; returns ``(basis, iters, degen)``."""
    with np.load(path) as data:
        basis = np.asarray(data["basis"], np.int32)
        iters = int(data["iters"])
        degen = int(data["degen"])
    if basis.shape != (m,):
        raise ValueError(f"snapshot basis shape {basis.shape} != ({m},)")
    if basis.min() < 0 or basis.max() >= n:
        raise ValueError("snapshot basis indices out of range")
    if len(np.unique(basis)) != m:
        raise ValueError("snapshot basis has duplicate columns")
    return basis, iters, degen


def _fit_to_options(prob, state: SolverState, opts: SimplexOptions) -> SolverState:
    """The leaves a snapshot does not carry, or carries for other options:
    the pending-pair buffers sized by ``opts`` (pairs pending in the
    snapshot folded into B_inv first), e and gamma under devex / steepest
    edge (dropped under Dantzig), an empty candidate buffer and a fresh
    perturbation record."""
    m, n = prob.A.shape
    dtype, dev = opts.dtype, prob.A.device
    L = opts.resolve_defer()
    st = dataclasses.replace(state)
    if st.U is not None and (L == 0 or tuple(st.U.shape) != (L, m)):
        st.B_inv = torch.addmm(st.B_inv, st.U.T, st.R)
        st.U = st.R = st.npend = None
    if L > 0 and st.U is None:
        st = dataclasses.replace(st, **_defer_extras(m, dtype, dev, L))
    weighted = opts.pricing in ("devex", "steepest")
    if weighted and st.e is None:
        st = dataclasses.replace(st, **_pricing_extras(prob, st.y, dtype, opts.pricing, B_inv=st.B_inv))
    elif not weighted:
        st.e = st.gamma = None
    if st.cand is None:
        st.cand = _cand_extras(m, n, dtype, dev, opts.multi_price)
    if st.pert is None:
        st.pert = _pert_extras(m, dtype, dev, opts.perturb_after > 0)
    return st


def solve_with_checkpoints(
    A,
    b,
    c,
    *,
    path,
    basis0: Optional[np.ndarray] = None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    resume: bool = True,
    on_chunk: Optional[Callable[[SolverState], None]] = None,
    A_host: Optional[np.ndarray] = None,
    device="cuda",
) -> SolveResult:
    """``solve`` in chunks of ``options.checkpoint_every`` pivots (1024 when
    0), on ``device`` (default ``"cuda"``; there is no fallback to the
    CPU), with a snapshot at ``path`` after every chunk (light when m >=
    ``LIGHT_FROM_M``). With ``resume`` and an existing
    ``path`` the solve continues from it. ``on_chunk(state)`` runs after
    each snapshot; an exception from it stops the solve, and a later call
    resumes from the snapshot. ``A`` may be sparse, as in ``solve``.

    The JAX package's retry loop (the chunk re-run after an UNAVAILABLE
    device error) answers a TPU runtime's failure and is not ported: a
    failed call is resumed by calling again. ``A_host`` is accepted for the
    reference's signature and not read: the reference polishes against a
    host copy of A, and this port polishes on the device against the A it
    already holds."""
    options = check_supported(options)
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A):
        A = np.asarray(A)
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    m, n = A.shape
    pin_full_fp32()
    device = torch.device(device)
    prob = build_problem(A, b, c, options, device)
    backend = get_backend(options.backend)
    defer = options.resolve_defer() > 0
    chunk = options.checkpoint_every if options.checkpoint_every > 0 else 1024
    max_iter = options.resolve_max_iter(m, n)
    light = m >= LIGHT_FROM_M
    path = os.fspath(path)

    if resume and os.path.exists(path):
        state = load_checkpoint(path, A=A, b=b, c=c, device=device)
        validate_checkpoint(state, A, b)
        state.status = torch.full_like(state.status, int(SolveStatus.RUNNING))
        state = _fit_to_options(prob, state, options)
        if int(state.last_refac) < int(state.iters):
            # a full snapshot's inverse has drifted: start from an exact one
            state = refactorize(prob, state, backend, defer, options.pricing)
    else:
        extras = dict(
            perturb=options.perturb_after > 0,
            update_defer=options.resolve_defer(),
            multi_price=options.multi_price,
            pricing=options.pricing,
        )
        if basis0 is None:
            state = initial_state_slack(prob, options.dtype, **extras)
        else:
            state = initial_state(prob, basis0, options.dtype, **extras)

    while True:
        limit = min(int(state.iters) + chunk, max_iter)
        state = solve_state(prob, state, options, limit, backend)
        status = SolveStatus(int(state.status))
        iters = int(state.iters)
        done = status != SolveStatus.MAX_ITER or iters >= max_iter
        if not done:
            # MAX_ITER at a chunk's end means: go on
            state.status = torch.full_like(state.status, int(SolveStatus.RUNNING))
        if state.pert is not None and bool(state.pert.on):
            # a snapshot carries no shift: re-derive x_b / y from the true rhs
            state = recompute_xy(prob, perturb_clear(state), defer)
        save_checkpoint(path, state, light=light)
        _log.info("chunk complete", extra=fields(iters=iters, status=status.name))
        if on_chunk is not None:
            on_chunk(state)
        if done:
            break
    return finalize_result(prob, b, c, state, options)
