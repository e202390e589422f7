"""Backend selection for the pivot step's hot ops.

``SimplexOptions.backend`` picks the op namespace the step calls:

  * ``"hopper"`` -- pricing (the basic-column mask and the choice of the
    entering column included; signed, too, under the bounded rule), the
    ratio tests (fused with the eta / x_b epilogue or with the step's whole
    O(m) tail, ``pivot_tail``; and the classic one alone) and the rank-1
    update (alone, or with the next step's ftran fused in,
    ``rank1_update_ftran``) run through the CUDA kernels
    (:mod:`simplex_tpu_torch.kernels.hopper`);
  * ``"torch"``  -- plain PyTorch ops everywhere
    (:mod:`simplex_tpu_torch.kernels.ops`), the kernels' reference.

Both expose the functions of ``simplex_tpu.kernels.dispatch``'s namespaces
that the dense path uses, so the step is backend-agnostic. As in
the JAX package's Pallas backend, the Harris ratio test without the eta
epilogue has no kernel of its own, and neither has the two-sided ratio
test of the bounded rule: the JAX package runs it through XLA on both
backends, so both namespaces here take the plain op. The bounded rule's
signed pricing is XLA in JAX too; here the hopper backend runs it through
``pricing_scan``'s signed mode, so the bf16 shadow is priced in place
rather than through an fp32 copy of it.

On a sparse A (:class:`~simplex_tpu_torch.sparse.SparseA`) the hopper
backend's pricing takes the plain ops (an SpMV and the masked argmin); the
ops that do not read A launch the same kernels as on dense A.

The hopper namespace also keeps ``step_graphs``
(:class:`~simplex_tpu_torch.core.graph.StepGraphs`): the CUDA graphs of the
default pivot step that ``core.step.pivot_step`` replays on CUDA tensors,
for as long as the namespace lives. No other namespace has it (the torch
one, the collective ones of ``dist/sharded.py``), so their steps launch op
by op.
"""

from __future__ import annotations

import types

from simplex_tpu_torch.config import BACKENDS
from simplex_tpu_torch.core.graph import StepGraphs
from simplex_tpu_torch.kernels import hopper as _hopper
from simplex_tpu_torch.kernels import ops as _ops


def get_backend(name: str) -> types.SimpleNamespace:
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend: {name!r} (want one of {BACKENDS})")
    fast = name == "hopper"
    return types.SimpleNamespace(
        name=name,
        choose_entering=_hopper.choose_entering if fast else _ops.choose_entering,
        ratio_eta=_hopper.ratio_eta if fast else _ops.ratio_eta,
        pivot_tail=_hopper.pivot_tail if fast else _ops.pivot_tail,
        ratio_argmin=_hopper.ratio_argmin if fast else _ops.ratio_argmin,
        ratio_argmin_harris=_ops.ratio_argmin_harris,
        choose_entering_bounded=(
            _hopper.choose_entering_bounded if fast else _ops.choose_entering_bounded
        ),
        ratio_argmin_bounded=_ops.ratio_argmin_bounded,
        rank1_update=_hopper.rank1_update if fast else _ops.rank1_update,
        # the update with the next step's ftran fused in: offered here, and
        # so taken by the default step (core.step), on both backends
        rank1_update_ftran=_hopper.rank1_update_ftran if fast else _ops.rank1_update_ftran,
        # the batched step (simplex_tpu_torch.batch): one launch a batch step
        # each on the hopper backend
        choose_entering_batched=(
            _hopper.choose_entering_batched if fast else _ops.choose_entering_batched
        ),
        pivot_tail_batched=_hopper.pivot_tail_batched if fast else _ops.pivot_tail_batched,
        rank1_update_batched=(
            _hopper.rank1_update_batched if fast else _ops.rank1_update_batched
        ),
        # torch ops on both backends, as they are XLA on both in the JAX
        # package: the devex / steepest-edge choice and its O(mn) updates
        devex_choose=_ops.devex_choose,
        devex_choose_bounded=_ops.devex_choose_bounded,
        pricing_update=_ops.pricing_update,
        pricing_update2=_ops.pricing_update2,
        gather_column=_ops.gather_column,
        gather_cost=_ops.gather_cost,
        gather_column_cost=_ops.gather_column_cost,
        gather_basis_matrix=_ops.gather_basis_matrix,
        step_graphs=StepGraphs() if fast else None,
    )
