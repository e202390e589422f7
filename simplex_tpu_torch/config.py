"""Solver configuration.

``SimplexOptions`` keeps the fields and defaults of
``simplex_tpu.config.SimplexOptions`` so that one option set means the same
solve in both packages. Two fields change meaning:

  * ``dtype`` is a ``torch.dtype``;
  * ``backend`` names the op set of the pivot step: ``"hopper"`` (the
    default) runs pricing, the ratio test and the B_inv update through the
    hand-written CUDA kernels of :mod:`simplex_tpu_torch.kernels.hopper`,
    ``"torch"`` runs plain PyTorch ops everywhere.

This port covers dense and sparse A, with or without native upper bounds
(``solve(u=)``, and the general-form route of ``solve_general`` on top).
Under the Dantzig rule: full, segmented (``partial_pricing``) or multiple
(``multi_price``) pricing, on A or on its bfloat16 shadow
(``pricing_dtype``), or on a sparse copy of a dense A (``pricing_sparse``),
with an exact recheck. Under ``pricing="devex"`` or
``"steepest"``: incremental reduced costs with devex reference weights or
exact steepest-edge norms, always in fp32 and over all columns (no shadow,
no segments; steepest edge refuses ``multi_price``, devex drops it). Under
every rule: the eager rank-1 or the deferred rank-L (``update_defer``)
update of B_inv; the Harris or the classic ratio test. The dual simplex
(``solve_dual``) takes ``dual_flip``. In float32 or float64 (``dtype``):
every kernel runs in either, in every mode (single, batched, sharded 1-D
and 2-D, the sharded batch), and the sharded modes carry their MIN keys in
the working dtype. An option that selects a path the port does not run
raises from :func:`check_supported` (steepest edge with ``multi_price``,
as in ``simplex_tpu.solve``); none is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BACKENDS = ("hopper", "torch")


@dataclasses.dataclass(frozen=True)
class SimplexOptions:
    """Options for the simplex solver (see ``simplex_tpu.config`` for the
    rationale behind each default)."""

    # optimality tolerance on reduced costs; None resolves by dtype
    eps: Optional[float] = None
    # ratio-test pivot tolerance: alpha_i must exceed it to be eligible
    pivot_tol: float = 1e-7
    # Harris pass-1 feasibility relaxation
    feas_tol: float = 1e-6
    # pivot limit; 0 means 50 * (m + n)
    max_iter: int = 0
    # re-invert the basis every K pivots (0 = never)
    refactor_every: int = 0
    # recompute x_b and y from the current inverse every K pivots (0 = never)
    recompute_every: int = 0
    # re-check every terminal decision against a re-inverted basis
    verify_terminal: bool = True
    # switch to Bland's rule after this many consecutive degenerate pivots
    bland_after: int = 64
    # degenerate-step threshold on theta
    degen_tol: float = 1e-9
    # arm the rhs perturbation after this many degenerate pivots (0 = off)
    perturb_after: int = 48
    perturb_scale: float = 1e-4
    perturb_grow: float = 2.0
    # arithmetic dtype of A, B_inv and the vectors
    dtype: torch.dtype = torch.float32
    # op set of the pivot step: "hopper" (CUDA kernels) or "torch" (plain)
    backend: str = "hopper"
    # "dantzig", "devex" (reference weights) or "steepest" (exact
    # Goldfarb-Reid norms: one more O(mn) and one O(m^2) pass a pivot for
    # shorter pivot paths)
    pricing: str = "dantzig"
    # "float32" (exact) or "bfloat16": price against a bf16 shadow of A and
    # recheck the winner in fp32; termination is always decided exactly
    pricing_dtype: str = "float32"
    # "harris" (default) or "classic"
    ratio: str = "harris"
    # keep up to L pending (eta, row) pairs and apply them to B_inv as one
    # rank-L GEMM every L pivots (0 = eager rank-1 update)
    update_defer: int = 0
    # price only segment (iters mod S) of the columns (0 / 1 = off); active
    # when S divides n and n / S >= partial_min_segment
    partial_pricing: int = 0
    partial_min_segment: int = 512
    # multiple pricing: a buffer of the K most improving columns, refilled
    # when no candidate still improves enough (0 = off)
    multi_price: int = 0
    multi_price_stale: float = 0.05
    multi_price_degen: int = 4
    # a dry segment retries over the full shadow before the exact pass
    fallback_shadow: bool = True
    # the dual simplex's bound-flipping (long-step) ratio test on boxed
    # problems; off = the textbook ratio test
    dual_flip: bool = True
    # Dantzig over a dense A: price against a sparse copy of A (at
    # pricing_dtype) and recheck the winner exactly; needs the full pass
    # (partial_pricing <= 1)
    pricing_sparse: bool = False
    # solve_with_checkpoints: pivots between snapshots (0 = 1024)
    checkpoint_every: int = 0
    # f64 refinement of the returned basis (when m <= polish_max_m)
    polish: bool = True
    polish_max_m: int = 16384

    def resolve_max_iter(self, m: int, n: int) -> int:
        return self.max_iter if self.max_iter > 0 else 50 * (m + n)

    def resolve_eps(self) -> float:
        if self.eps is not None:
            return self.eps
        return 1e-9 if self.dtype.itemsize >= 8 else 1e-5

    def resolve_defer(self) -> int:
        if self.multi_price > 0:
            return max(self.update_defer, self.multi_price)
        return self.update_defer


DEFAULT_OPTIONS = SimplexOptions()


PRICING_RULES = ("dantzig", "devex", "steepest")


def pin_full_fp32() -> None:
    """Matrix products in full fp32 (TF32 off): every entry point calls this
    first, the counterpart of the JAX package's ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_supported(opts: SimplexOptions) -> SimplexOptions:
    """Raise for an option value this port does not run, and return the
    options the solve runs with: ``simplex_tpu.solve``'s own two rules on
    the weighted pricing rules are applied here (steepest edge with
    ``multi_price`` raises; devex drops ``multi_price`` with a warning)."""
    if opts.backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend: {opts.backend!r} (want one of {BACKENDS})"
        )
    if opts.ratio not in ("harris", "classic"):
        raise ValueError(f"unknown ratio test: {opts.ratio!r}")
    if opts.pricing not in PRICING_RULES:
        raise ValueError(f"unknown pricing rule: {opts.pricing!r} (want one of {PRICING_RULES})")
    if opts.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {opts.dtype}")
    if opts.pricing_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"pricing_dtype must be 'float32' or 'bfloat16', got {opts.pricing_dtype!r}"
        )
    if opts.pricing == "steepest" and opts.multi_price > 0:
        raise NotImplementedError(
            "pricing='steepest' maintains exact norms every pivot (the weight "
            "recurrence needs the full w / v passes); it does not compose with "
            "multi_price's buffered minor pivots. It does compose with "
            "update_defer."
        )
    if opts.pricing == "devex" and opts.multi_price > 0:
        # multiple pricing is Dantzig-only; left on it would size the
        # deferred and candidate buffers by K for nothing
        from simplex_tpu_torch.logging import get_logger

        get_logger("solver").warning(
            "multi_price=%d is inert under pricing='devex' (dantzig only); "
            "solving without multiple pricing", opts.multi_price,
        )
        opts = dataclasses.replace(opts, multi_price=0)
    return opts

