"""The comparison that decides ``correct``.

After the window has closed and the peak memory has been read, the plain
float64 reference (``reference/simplex64.py``) works out again, from A, b
and c made again from the seed, what the program derived, and judges the
answers the window produced: every sampled pivot (its entering column, its
leaving row, the x_b it left), every segment's final state (x_b, y, the
inverse) and every solve's result (x_b, y, z, its status). Each number is
the widest gap over those answers (``simplex64``'s module docstring defines
them). A cell's limits (``limits/<workload>.json``) say which numbers it
compares and the limit of each, with the two readings it was set from; a
number without a limit is printed and not compared. A solve that did not
end OPTIMAL, or a window whose loop stalled, fails outright.

``control=True`` judges the control (``reference/lowprec.py``) at the same
answers' bases instead of the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import lowprec
from benchmark.reference import simplex64 as ref64

OPTIMAL = 1  # SolveStatus.OPTIMAL, the same code in both packages


def _source(inputs, instance):
    A, b, c = inputs(instance)
    return ref64.tensor_source(A), b, c


def judge(records: dict, inputs, rule: str, pivot_tol: float, feas_tol: float,
          control: bool = False, source=None) -> list:
    """One dict of numbers for each answer judged (a sampled pivot, a final
    state, a solve; a solve that did not end OPTIMAL reads
    ``{"not_optimal": 1}``). ``inputs(instance)`` makes (A, b, c) again;
    ``source(instance)``, where given, makes (column source, b, c) instead
    (a column-sharded A that one card never holds whole)."""
    items = []
    make = source or (lambda i: _source(inputs, i))
    cache = {}

    def src(i):
        if i not in cache:
            cache.clear()
            cache[i] = make(i)
        return cache[i]

    for rec in records.get("pivots", []):
        pq = ref64.entering_leaving(rec["basis0"], rec["basis1"])
        if pq is None:
            continue
        p, q = pq
        cols, b, c = src(rec.get("instance"))
        before = ref64.Basis(cols, b, c, rec["basis0"])
        gamma = before.steepest_norms() if rule == "steepest" else None
        alpha = before.solve(before.column(p))
        if control:
            ctl = lowprec.Control(before)
            p, q = ctl.entering(rule), ctl.leaving(p, pivot_tol, feas_tol)
            del ctl
        got = {"pricing_gap": ref64.pricing_gap(before, p, rule, gamma=gamma),
               "ratio_gap": ref64.ratio_gap(before, alpha, q, pivot_tol)}
        del before, gamma
        after = ref64.Basis(cols, b, c, rec["basis1"])
        got["xb_err"] = ref64.xb_err(after, lowprec.Control(after).x if control else rec["x_b1"])
        items.append(got)
        del after

    for st in records.get("states", []):
        cols, b, c = src(None)
        ref = ref64.Basis(cols, b, c, st["basis"])
        if control:
            ctl = lowprec.Control(ref)
            x_b, y, B_inv = ctl.x, ctl.y, ctl.inv
            del ctl
        else:
            x_b, y, B_inv = st["x_b"], st["y"], st["B_inv"]
        items.append({"xb_err": ref64.xb_err(ref, x_b), "y_err": ref64.y_err(ref, y),
                      "binv_err": ref64.binv_err(ref, B_inv)})
        del ref, x_b, y, B_inv

    for item in records.get("solves", []):
        res = item["result"]
        if int(res.status) != OPTIMAL:
            items.append({"not_optimal": 1})
            continue
        cols, b, c = src(item["instance"])
        ref = ref64.Basis(cols, b, c, torch.as_tensor(res.basis))
        if control:
            ctl = lowprec.Control(ref)
            x_b, y, z = ctl.x, ctl.y, ctl.z()
        else:
            x_b, y, z = torch.as_tensor(res.x_b), torch.as_tensor(res.y), res.z
        got = {"xb_err": ref64.xb_err(ref, x_b), "primal_infeas": ref64.primal_infeas(x_b),
               "dual_infeas": ref64.dual_infeas(ref, y), "z_err": ref64.z_err(ref, z)}
        if not control:
            got["feas_err"] = float(res.feas_err)  # the program's own f64 reading
        items.append(got)
        del ref
    return items


def worst(items: list) -> dict:
    """Each number's widest reading over the answers."""
    out = {}
    for got in items:
        for k, v in got.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def failed(items: list, limits: dict) -> int:
    """Answers that fail: one compared number over its limit, or a solve
    that did not end OPTIMAL."""
    return sum(
        1 for got in items
        if "not_optimal" in got or any(not v <= limits[k]["limit"] for k, v in got.items() if k in limits)
    )


def compare(worst: dict, limits: dict):
    """[(name, value, limit or None, ok)] for every number read; a number
    the cell compares and that was not read fails (nothing was judged)."""
    rows = []
    if "not_optimal" in worst:
        rows.append(("not_optimal", worst["not_optimal"], 0, False))
    for name, spec in limits.items():
        v = worst.get(name, math.nan)
        rows.append((name, v, spec["limit"], bool(v <= spec["limit"])))
    rows += [(name, v, None, True) for name, v in sorted(worst.items()) if name not in limits and name != "not_optimal"]
    return rows
