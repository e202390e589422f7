"""First-order LP solvers (PDHG, PDLP-style): the inverse-free mode."""

from simplex_tpu_torch.fo.pdhg import PDHGResult, solve_pdhg


def __getattr__(name):
    if name == "solve_pdhg_sharded":
        raise NotImplementedError(
            "solve_pdhg_sharded (PDHG sharded over several cards) is not ported yet "
            "(ROADMAP item 18)"
        )
    raise AttributeError(f"module 'simplex_tpu_torch.fo' has no attribute {name!r}")


__all__ = ["PDHGResult", "solve_pdhg", "solve_pdhg_sharded"]
