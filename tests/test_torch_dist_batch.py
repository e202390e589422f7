"""The port's sharded batch and its multi-process rendezvous.

``solve_batched(mesh=)`` and ``reoptimize_batched(mesh=)`` on 2 to 4 gloo
CPU ranks (one pool of four spawned once for the module) against the same
calls without a mesh and against ``simplex_tpu.batch.vmapped.solve_batched``
on the conftest's 8-device virtual mesh (``tests/test_batch.py::
test_batched_sharded_over_mesh``): statuses equal, z within 1e-6 relative,
every rank returning the whole batch. Then ``tests/test_multiprocess.py``'s
two-process rendezvous through the port's ``initialize_multihost``: two
processes, one gloo rank each, one column-sharded solve across them.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from simplex_tpu.batch.vmapped import solve_batched as jax_solve_batched
from simplex_tpu.dist.mesh import BATCH_AXIS
from simplex_tpu.dist.mesh import make_mesh as jax_make_mesh
from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched, solve, solve_batched
from simplex_tpu_torch.dist.mesh import free_port
from simplex_tpu_torch.oracle.generator import random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy
from torch_dist_ranks import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def stack_lps(B, m, n, seed0=100):
    lps = [random_dense_lp(m, n, seed=seed0 + s, dtype=np.float32) for s in range(B)]
    return [np.stack([lp[k] for lp in lps]) for k in range(3)]


def same_on_every_rank(out, R):
    got = out[:R]
    for r in got[1:]:
        for f in got[0]._fields:
            a, b = getattr(got[0], f), getattr(r, f)
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
    assert all(o is None for o in out[R:])
    return got[0]


def assert_batch_equal(res, ref):
    np.testing.assert_array_equal(res.status, ref.status)
    np.testing.assert_allclose(res.z, ref.z, rtol=1e-6)
    assert res.z.shape == ref.z.shape and res.basis.shape == ref.basis.shape


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_batched_sharded_over_mesh(pool, R, backend):
    # tests/test_batch.py::test_batched_sharded_over_mesh; 16 LPs over 3
    # ranks split 6 / 5 / 5
    As, bs, cs = stack_lps(16, 8, 20)
    opts = SimplexOptions(backend=backend)
    res = same_on_every_rank(pool.run("batched", R, As, bs, cs, opts), R)
    assert_batch_equal(res, solve_batched(As, bs, cs, options=opts, device="cpu"))
    jres = jax_solve_batched(As, bs, cs, mesh=jax_make_mesh(axis_names=(BATCH_AXIS,)))
    assert_batch_equal(res, jres)


def test_batched_over_more_ranks_than_instances(pool):
    As, bs, cs = stack_lps(3, 8, 20, seed0=7)
    opts = SimplexOptions(update_defer=4)
    res = same_on_every_rank(pool.run("batched", 4, As, bs, cs, opts), 4)
    assert_batch_equal(res, solve_batched(As, bs, cs, options=opts, device="cpu"))
    for i in range(3):
        assert relative_gap(float(res.z[i]), solve_scipy(As[i], bs[i], cs[i]).z) < 1e-4


def test_batched_error_reaches_every_rank(pool):
    # 3 LPs over 4 ranks: the three ranks with an LP refuse the bounds, and
    # the fourth, which has none, raises the same error instead of waiting
    As, bs, cs = stack_lps(3, 8, 20, seed0=7)
    u = np.full(20, -1.0)
    errs = pool.run("batched_error", 4, As, bs, cs, u)
    assert all(e == ("ValueError", "negative upper bound (shift lowers to 0 first)") for e in errs)


@pytest.mark.parametrize("R", [2, 3])
def test_reoptimize_batched_over_mesh(pool, R):
    A, b, c = random_dense_lp(12, 30, seed=61, dtype=np.float32)
    prev = solve(A, b, c, device="cpu")
    assert prev.status == SolveStatus.OPTIMAL
    rng = np.random.default_rng(1)
    bs = (b[None, :] * (1 + 0.05 * rng.uniform(-1, 1, (7, b.shape[0])))).astype(np.float32)
    opts = SimplexOptions()
    res = same_on_every_rank(pool.run("reoptimized", R, A, bs, c, prev, opts), R)
    ref = reoptimize_batched(A, bs, c, prev, options=opts, device="cpu")
    assert_batch_equal(res, ref)
    np.testing.assert_allclose(res.feas_err, ref.feas_err, rtol=1e-6, atol=1e-12)
    for i in range(len(bs)):
        assert relative_gap(float(res.z[i]), solve_scipy(A, bs[i], c).z) < 1e-4


_WORKER = r"""
import sys

coord, pid = sys.argv[1], int(sys.argv[2])

import numpy as np
import torch.distributed as dist

from simplex_tpu_torch import SimplexOptions, SolveStatus, solve_sharded
from simplex_tpu_torch.dist.mesh import initialize_multihost, make_mesh
from simplex_tpu_torch.oracle.generator import random_dense_lp

initialize_multihost(coordinator_address=coord, num_processes=2, process_id=pid, backend="gloo")
assert dist.get_world_size() == 2, dist.get_world_size()
A, b, c = random_dense_lp(8, 16, seed=21, dtype=np.float32)
res = solve_sharded(A, b, c, make_mesh(device="cpu"), options=SimplexOptions(backend="torch"))
assert res.status == SolveStatus.OPTIMAL, res.status
print(f"RESULT {pid} {res.z!r}", flush=True)
dist.destroy_process_group()
"""


def test_two_process_distributed_solve():
    coord = f"127.0.0.1:{free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=Path(__file__).resolve().parents[1],
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"worker failed:\n{out}"
    zs = [float(line.split()[2]) for out in outs for line in out.splitlines() if line.startswith("RESULT")]
    assert len(zs) == 2, outs
    assert zs[0] == zs[1]
    A, b, c = random_dense_lp(8, 16, seed=21, dtype=np.float32)
    assert relative_gap(zs[0], solve_scipy(A, b, c).z) < 1e-5


@pytest.mark.parametrize("m,n", [(5, 17), (64, 200)])
def test_card_check_instance_is_random_dense_lp(tmp_path, m, n):
    # the four-card check writes A row block by row block from the same
    # random stream: the instance is random_dense_lp's, bit for bit
    from simplex_tpu_torch.dist.card_check import dense_lp_memmap

    path, b, c = dense_lp_memmap(m, n, 0, tmp_path)
    A0, b0, c0 = random_dense_lp(m, n, seed=0)
    np.testing.assert_array_equal(np.load(path, mmap_mode="r"), A0)
    np.testing.assert_array_equal(b, b0)
    np.testing.assert_array_equal(c, c0)


def test_card_check_rehearses_on_cpu_ranks(tmp_path, capsys):
    # the four-card check's whole flow on two gloo CPU ranks at a tiny size:
    # the sharded window equals the single solve's, on every rank
    import json

    from simplex_tpu_torch.dist import card_check

    out = tmp_path / "cc.json"
    rc = card_check.main(["--device", "cpu", "--ranks", "2", "--m", "24", "--n", "80",
                          "--window", "16", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["ranks_agree"] and rec["matches_single_card"]
    assert rec["pivots"] == 16 and rec["sharded_reads"] == rec["single_reads"]
    assert rec["sharded_collectives_per_step"]["choose_entering"] == 1.0
