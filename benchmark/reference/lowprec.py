"""The control: the reference put in the program's place in bfloat16.

The configurations state float32; the nearest precision below, the step a
later change could be tempted to take, is bfloat16. At the states the
program's window passed through, the control makes the program's decisions
and answers with every operand rounded to bfloat16 and products summed in
float32 (as a tensor core does): the entering column, the leaving row,
x_b, y, the inverse. :mod:`simplex64` then judges them by the same numbers
it judges the program by. The control starts from the float64 inverse
rounded to bfloat16, which is kinder to it than an inverse built in
bfloat16 would be, so its readings are low ones.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import simplex64 as ref64

BF16 = torch.bfloat16


def round16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).to(torch.float64)


def mm16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bfloat16 operands summed in float32, rounded to bfloat16."""
    return round16(a.to(BF16).float() @ b.to(BF16).float())


class Control:
    """The control's answers at one basis (``ref``: its float64 judge)."""

    def __init__(self, ref: ref64.Basis):
        self.ref = ref
        self.inv = round16(ref.inverse())
        self.x = mm16(self.inv, ref.b.view(-1, 1)).view(-1)
        self.y = mm16(ref.c.index_select(0, ref.basis).view(1, -1), self.inv).view(-1)

    def reduced_costs(self) -> torch.Tensor:
        d = torch.cat([mm16(self.y.view(1, -1), blk).view(-1) for _, _, blk in self.ref.src.blocks()])
        d = round16(d - round16(self.ref.c))
        return d.index_fill(0, self.ref.basis, math.inf)

    def steepest_norms(self) -> torch.Tensor:
        out = []
        for _, _, blk in self.ref.src.blocks():
            T = mm16(self.inv, blk)
            out.append(round16(1 + (T * T).sum(0)))
        return torch.cat(out)

    def entering(self, rule: str) -> int:
        d = self.reduced_costs()
        if rule == "steepest":
            d = d / self.steepest_norms().sqrt()
        return int(torch.argmin(d))

    def leaving(self, p: int, pivot_tol: float, feas_tol: float) -> int:
        """Harris's two passes on the control's x and alpha."""
        alpha = mm16(self.inv, self.ref.column(p).view(-1, 1)).view(-1)
        elig = alpha > pivot_tol
        bound = torch.where(elig, (self.x + feas_tol) / alpha, math.inf).min()
        ok = elig & (self.x / alpha <= bound)
        return int(torch.argmax(torch.where(ok, alpha, -math.inf)))

    def z(self) -> float:
        return float(round16(self.ref.c.index_select(0, self.ref.basis)) @ self.x)
