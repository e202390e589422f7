"""Test and benchmark instances (numpy only).

Copies of ``simplex_tpu.oracle.generator``'s instances, so that a machine
without jax builds the same LPs from the same seeds: the canonical-form
ones (a trailing identity slack block, the starting basis of ``solve``)
and the structured general-form ones (a
:class:`~simplex_tpu_torch.core.twophase.GeneralLP` each, for
``solve_general``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_dense_lp(
    m: int,
    n: int,
    seed: int = 0,
    dtype=np.float32,
    degenerate: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, b, c) with A (m, n) whose last m columns are I; feasible at the
    slack basis (b > 0) and bounded (positive structural columns).

    ``n`` counts all columns including the m slacks.
    """
    if n <= m:
        raise ValueError(f"need n > m, got m={m} n={n}")
    rng = np.random.default_rng(seed)
    k = n - m
    A_raw = rng.uniform(0.1, 1.0, size=(m, k))
    A = np.concatenate([A_raw, np.eye(m)], axis=1).astype(dtype)
    b = rng.uniform(1.0, 2.0, size=m).astype(dtype)
    c = np.concatenate(
        [rng.uniform(0.1, 1.0, size=k), np.zeros(m)]
    ).astype(dtype)
    if degenerate:
        b[: m // 2] = b[0]
        c[: max(1, k // 4)] = c[0]
    return A, b, c


def klee_minty_lp(n: int):
    """Klee-Minty cube in canonical slack form (maximize). Dantzig pricing
    visits all 2^n - 1 improving vertices; the optimum is 5^n."""
    A = np.zeros((n, 2 * n))
    b = np.zeros(n)
    c = np.zeros(2 * n)
    for i in range(n):
        for j in range(i):
            A[i, j] = 2.0 ** (i - j + 1)
        A[i, i] = 1.0
        A[i, n + i] = 1.0  # slack
        b[i] = 5.0 ** (i + 1)
        c[i] = 2.0 ** (n - 1 - i)
    return A, b, c


def degenerate_streak_lp(m: int = 24, n: int = 60, seed: int = 5):
    """Canonical LP whose slack start sits on a highly degenerate vertex
    (every fourth rhs entry is zero): the walk runs through streaks of
    zero-theta pivots, which arms the rhs perturbation."""
    rng = np.random.default_rng(seed)
    k = n - m
    G = rng.uniform(0.1, 1.0, (m, k)) * (rng.random((m, k)) < 0.3)
    A = np.concatenate([G, np.eye(m)], axis=1).astype(np.float32)
    b = rng.uniform(1.0, 2.0, m).astype(np.float32)
    b[::4] = 0.0
    c = np.concatenate([rng.uniform(0.5, 2.0, k), np.zeros(m)]).astype(
        np.float32
    )
    return A, b, c


def transportation_lp(ns: int, nd: int, seed: int = 0, balanced: bool = True):
    """Transportation problem as a GeneralLP (maximize -cost).

    ns supply rows (<=), nd demand rows (>=), ns*nd shipment variables.
    ``balanced=True`` makes total supply == total demand — every basic
    feasible solution is then degenerate (the classic stress test for
    anti-cycling; netlib's transportation-derived instances share it).
    """
    from simplex_tpu_torch.core.twophase import GeneralLP

    rng = np.random.default_rng(seed)
    supply = rng.integers(10, 50, size=ns).astype(np.float64)
    demand = rng.integers(5, 40, size=nd).astype(np.float64)
    if balanced:
        # scale demand to exactly match supply (keep integers for exact ties)
        total_s = supply.sum()
        demand = np.floor(demand * total_s / demand.sum())
        demand[0] += total_s - demand.sum()
    else:
        # ensure feasibility: total supply >= total demand
        excess = demand.sum() - supply.sum()
        if excess > 0:
            supply[0] += excess + 1
    cost = rng.integers(1, 20, size=(ns, nd)).astype(np.float64)

    k = ns * nd
    A = np.zeros((ns + nd, k))
    for i in range(ns):
        A[i, i * nd : (i + 1) * nd] = 1.0  # sum_j x_ij <= supply_i
    for j in range(nd):
        A[ns + j, j::nd] = 1.0  # sum_i x_ij >= demand_j
    b = np.concatenate([supply, demand])
    c = -cost.ravel()  # maximize negative cost == minimize cost
    row_types = ["L"] * ns + ["G"] * nd
    return GeneralLP(A=A, b=b, c=c, row_types=row_types)


def assignment_lp(n: int, seed: int = 0):
    """n x n assignment problem — maximally degenerate network LP.

    Every extreme point has 2n-1 basic variables of which n-1 are zero, so
    simplex takes long runs of degenerate pivots (exercises the Bland
    fallback on a structure random dense LPs never produce).
    """
    from simplex_tpu_torch.core.twophase import GeneralLP

    rng = np.random.default_rng(seed)
    cost = rng.integers(1, 30, size=(n, n)).astype(np.float64)
    k = n * n
    A = np.zeros((2 * n, k))
    for i in range(n):
        A[i, i * n : (i + 1) * n] = 1.0  # rows: sum_j x_ij = 1
        A[n + i, i::n] = 1.0  # cols: sum_i x_ij = 1
    b = np.ones(2 * n)
    return GeneralLP(A=A, b=b, c=-cost.ravel(), row_types=["E"] * 2 * n)


def production_lp(n_products: int, n_resources: int, seed: int = 0):
    """Bounded production planning: max profit, resource rows, per-product
    capacity bounds (finite uppers — exercises the bounds pipeline), a few
    contractual minimums (shifted lowers)."""
    from simplex_tpu_torch.core.twophase import GeneralLP

    rng = np.random.default_rng(seed)
    A = rng.uniform(0.5, 3.0, size=(n_resources, n_products))
    b = rng.uniform(20.0, 60.0, size=n_resources) * n_products / 4
    profit = rng.uniform(1.0, 10.0, size=n_products)
    upper = rng.uniform(2.0, 15.0, size=n_products)
    lower = np.zeros(n_products)
    # contractual minimums on the first quarter of products (kept small so
    # the instance stays feasible)
    nq = max(1, n_products // 4)
    lower[:nq] = rng.uniform(0.1, 0.8, size=nq)
    return GeneralLP(
        A=A, b=b, c=profit, row_types=["L"] * n_resources,
        lower=lower, upper=upper,
    )


def multiperiod_production_lp(T: int, P: int, seed: int = 0):
    """Netlib-class multi-period production planning (SCTAP/SCSD-style):
    hundreds to thousands of rows, mostly-sparse equality structure, bounds
    on most columns, made deterministically from a seed:

      variables (3*T*P, ALL bounded above):
        x[t,p]  production    0 <= x <= cap_p       (machine capacity)
        s[t,p]  end inventory 0 <= s <= store_p     (warehouse capacity)
        v[t,p]  sales         0 <= v <= demand_t_p  (market size)
      rows (T*P equalities + T inequalities):
        balance[t,p] (E):  s[t-1,p] + x[t,p] - v[t,p] - s[t,p] = 0
                           (s[-1,p] = 0: start empty)
        hours[t]     (L):  sum_p h_p * x[t,p] <= H_t
      objective: max  sum_t,p  price*v - prodcost*x - holdcost*s

    Feasible at the origin (produce/sell/store nothing), so phase 1 must
    work the T*P artificial columns of the equality block out of the basis
    — the same shape of work a netlib instance demands. Row count T*(P+1),
    column count 3*T*P; e.g. T=64, P=16 gives 1088 rows, 3072 bounded
    structural columns.
    """
    from simplex_tpu_torch.core.twophase import GeneralLP

    rng = np.random.default_rng(seed)
    cap = rng.uniform(5.0, 20.0, size=P)  # per-product production cap
    store = rng.uniform(3.0, 12.0, size=P)
    demand = rng.uniform(1.0, 10.0, size=(T, P))
    hours = rng.uniform(0.5, 2.0, size=P)
    H = rng.uniform(0.4, 0.9, size=T) * (hours * cap).sum()
    price = rng.uniform(4.0, 12.0, size=P)
    prodcost = rng.uniform(1.0, 3.0, size=P)
    holdcost = rng.uniform(0.1, 0.5, size=P)

    nv = 3 * T * P  # [x | s | v] blocks, each T*P in t-major order
    xs, ss, vs = 0, T * P, 2 * T * P

    def ix(base, t, p):
        return base + t * P + p

    m = T * P + T
    A = np.zeros((m, nv))
    b = np.zeros(m)
    row_types = []
    for t in range(T):
        for p in range(P):
            r = t * P + p
            A[r, ix(xs, t, p)] = 1.0
            A[r, ix(vs, t, p)] = -1.0
            A[r, ix(ss, t, p)] = -1.0
            if t > 0:
                A[r, ix(ss, t - 1, p)] = 1.0
            row_types.append("E")
    for t in range(T):
        r = T * P + t
        for p in range(P):
            A[r, ix(xs, t, p)] = hours[p]
        b[r] = H[t]
    row_types += ["L"] * T

    c = np.concatenate(
        [
            -np.tile(prodcost, T),
            -np.tile(holdcost, T),
            np.tile(price, T),
        ]
    )
    upper = np.concatenate(
        [np.tile(cap, T), np.tile(store, T), demand.ravel()]
    )
    return GeneralLP(
        A=A, b=b, c=c, row_types=row_types,
        lower=np.zeros(nv), upper=upper,
    )


def beale_cycling_lp():
    """Beale's classic cycling example (canonical form, maximize).

    Dantzig pricing with exact ratio ties cycles forever on this LP; it
    terminates only via an anti-cycling rule. Optimum 0.05 at
    x = (1/25, 0, 1, 0) for max 3/4 x1 - 150 x2 + 1/50 x3 - 6 x4.
    Reference: Beale (1955).
    """
    A = np.array(
        [
            [0.25, -60.0, -1.0 / 25.0, 9.0, 1.0, 0.0, 0.0],
            [0.5, -90.0, -1.0 / 50.0, 3.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
        ]
    )
    b = np.array([0.0, 0.0, 1.0])
    c = np.array([0.75, -150.0, 1.0 / 50.0, -6.0, 0.0, 0.0, 0.0])
    return A, b, c
