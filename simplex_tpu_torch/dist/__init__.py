"""Distributed modes on ``torch.distributed``: the mesh of ranks
(:mod:`~simplex_tpu_torch.dist.mesh`) and the column-sharded solve
(:mod:`~simplex_tpu_torch.dist.sharded`)."""
