"""The mesh of ranks and the multi-process rendezvous.

The counterpart of ``simplex_tpu.dist.mesh``. JAX builds a ``Mesh`` over
the devices it sees and rides its collectives on the chips' links; here a
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group, one process a rank. On the cards each rank
drives ``cuda:<rank mod cards>`` and the collectives run over NCCL; on the
CPU (``device="cpu"``, as the tests run it) over gloo. A process group the
caller made beforehand is used as it is, whatever its transport: two ranks
that share one card must use gloo, since NCCL refuses a card twice.
"""

from __future__ import annotations

import datetime
import socket
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

COLS_AXIS = "cols"
ROWS_AXIS = "rows"
BATCH_AXIS = "batch"

# how long a rank waits for the others at a rendezvous or a collective
TIMEOUT = datetime.timedelta(minutes=10)

# mesh -> the process group of all its ranks, for meshes of two or more axes
_flat_groups: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def free_port() -> int:
    """A TCP port of this host that is free now (for a ``tcp://``
    rendezvous on ``127.0.0.1``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _transport(device: str) -> str:
    dev = torch.device(device).type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return "nccl" if dev == "cuda" else "gloo"


def make_mesh(
    axis_names: Sequence[str] = (COLS_AXIS,),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device: str = "cuda",
):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks
    ``devices`` (default: every rank of the process group), shaped
    ``shape`` (default: all of them along the first axis), with the axes
    ``axis_names`` (``"cols"``: the column-sharded solve; ``"batch"``: the
    sharded batch; ``("rows", "cols")`` with ``shape=(R, C)``: the 2-D
    solve). A mesh of two or more axes also gets the group of all its ranks
    (:func:`flat_group`).

    Every rank of the process group calls this, the ranks outside
    ``devices`` too (each mesh axis is a new process group). Without a
    process group it first makes one of world size 1 (NCCL for
    ``device="cuda"``, gloo for ``"cpu"``). On the cards each rank drives
    ``cuda:<rank mod device_count>``. Each axis's communicator is set up
    before the call returns."""
    from torch.distributed.device_mesh import DeviceMesh

    backend = _transport(device)
    dev_type = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
            timeout=TIMEOUT,
        )
    if dev_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    grid = np.asarray(ranks, dtype=np.int64).reshape(tuple(shape))
    mesh = DeviceMesh(dev_type, torch.as_tensor(grid), mesh_dim_names=tuple(axis_names))
    groups = [mesh.get_group(name) for name in axis_names] if mesh.get_coordinate() is not None else []
    if len(axis_names) > 1:
        # every rank of the process group takes part in making a group
        _flat_groups[mesh] = dist.new_group(ranks=grid.ravel().tolist())
        if groups:
            groups.append(_flat_groups[mesh])
    if groups:
        # make each communicator now (NCCL makes one at its first
        # collective, which takes a second or more), not inside a solve
        probe = torch.zeros(1, device=torch.cuda.current_device() if dev_type == "cuda" else "cpu")
        for group in groups:
            dist.all_reduce(probe, group=group)
    return mesh


def flat_group(mesh):
    """The process group of every rank of ``mesh``: its one axis's group,
    or for a mesh of several axes the group :func:`make_mesh` made beside
    it (the flattened mesh). A rank's place along the flattened mesh is
    its coordinate in row-major order, whatever its rank in this group."""
    mesh = require_mesh(mesh)
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh not in _flat_groups:
        raise ValueError(
            "flat_group: a mesh of several axes must come from simplex_tpu_torch.dist.mesh.make_mesh, "
            "which makes the group of all its ranks"
        )
    return _flat_groups[mesh]


def require_mesh(mesh):
    """``mesh`` when it is a :class:`~torch.distributed.device_mesh.DeviceMesh`;
    raises ``TypeError`` otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh: want a torch.distributed DeviceMesh (simplex_tpu_torch.dist.mesh.make_mesh), "
            f"got {type(mesh).__name__}"
        )
    return mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
) -> None:
    """Join the process group of ``num_processes`` processes through the
    rendezvous at ``coordinator_address`` (``host:port``; this process is
    rank ``process_id``), over ``backend`` (``"nccl"`` on the cards,
    ``"gloo"`` on the CPU). Call once a process.

    A call that names a rendezvous raises when it cannot join it: it never
    goes on as a single process. A call without arguments is a no-op (there
    is nothing to join), and so is any call once the group exists."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_multihost: give coordinator_address, num_processes and process_id"
        )
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=TIMEOUT,
    )
