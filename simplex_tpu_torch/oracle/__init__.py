"""Correctness oracles and problem generators (``simplex_tpu.oracle``'s
names): HiGHS through scipy, and the native f64 simplex built with g++ at
first use."""

from simplex_tpu_torch.oracle.generator import random_dense_lp
from simplex_tpu_torch.oracle.reference import OracleResult, relative_gap, solve_scipy


def get_oracle(name: str):
    if name == "scipy":
        return solve_scipy
    if name == "native":
        from simplex_tpu_torch.oracle.native import solve_native

        return solve_native
    raise ValueError(f"unknown oracle {name!r} (want 'scipy' or 'native')")


__all__ = [
    "OracleResult",
    "get_oracle",
    "random_dense_lp",
    "relative_gap",
    "solve_scipy",
]
