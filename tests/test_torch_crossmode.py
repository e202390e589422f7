"""Cross-mode consistency on the port: every solver configuration must
agree. The counterpart of ``tests/test_crossmode.py``: one instance a
seed, every route (Dantzig full / shadow / segmented / multiple pricing,
devex, exact steepest edge, the deferred-update flagship, the classic
ratio test, the sparse pricing copy; dense A and scipy CSR), the batched
lane and the first-order mode, all pinned to HiGHS, to each other and to
the JAX package's answer on the same inputs. The knobs change the path,
never the answer.

Tolerances: the JAX test's own gates (1e-5 against HiGHS for the simplex
routes, the fp32 gate; 1e-4 for the batched lane and PDHG at tol 1e-6).
"""

import numpy as np
import pytest
import scipy.sparse as sps

import simplex_tpu
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve, solve_batched, solve_pdhg
from simplex_tpu_torch.oracle.generator import random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

CONFIGS = {
    "dantzig": dict(refactor_every=64),
    "shadow": dict(pricing_dtype="bfloat16", refactor_every=64),
    "segmented": dict(partial_pricing=4, partial_min_segment=1, refactor_every=64),
    "multi": dict(multi_price=8, refactor_every=64),
    "devex": dict(pricing="devex", refactor_every=64),
    "steepest": dict(pricing="steepest", refactor_every=64),
    "flagship": dict(
        pricing_dtype="bfloat16", partial_pricing=4, partial_min_segment=1,
        update_defer=8, refactor_every=64,
    ),
    "classic-ratio": dict(ratio="classic", refactor_every=64),
    "sparse-price": dict(pricing_sparse=True, refactor_every=64),
}

# the routes that also run with A stored sparse (pricing_sparse prices a
# sparse copy of a dense A)
SPARSE_OK = ("dantzig", "shadow", "segmented", "multi", "devex", "steepest",
             "flagship", "classic-ratio")


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_every_route_agrees(seed):
    A, b, c = random_dense_lp(24, 64, seed=seed)
    ref = solve_scipy(A, b, c)
    assert ref.status == SolveStatus.OPTIMAL
    jz = simplex_tpu.solve(A, b, c).z
    assert relative_gap(jz, ref.z) < 1e-5
    A_sp = sps.csr_matrix(np.asarray(A))
    zs = {}
    for name, kw in CONFIGS.items():
        opts = SimplexOptions(**kw)
        res = solve(A, b, c, options=opts, device="cpu")
        assert res.status == SolveStatus.OPTIMAL, name
        assert relative_gap(res.z, ref.z) < 1e-5, (name, res.z, ref.z)
        zs[name] = res.z
        if name in SPARSE_OK:
            rs = solve(A_sp, b, c, options=opts, device="cpu")
            assert rs.status == SolveStatus.OPTIMAL, f"sparse:{name}"
            assert relative_gap(rs.z, ref.z) < 1e-5, (f"sparse:{name}", rs.z)
            zs[f"sparse:{name}"] = rs.z
    # the routes against each other and the JAX package's answer
    for name, z in zs.items():
        assert relative_gap(z, jz) < 1e-5, (name, z, jz)
    bres = solve_batched(A[None], b[None], c[None], device="cpu")
    assert SolveStatus(int(bres.status[0])) == SolveStatus.OPTIMAL
    assert relative_gap(float(bres.z[0]), ref.z) < 1e-4
    fo = solve_pdhg(A, b, c, tol=1e-6, device="cpu")
    assert fo.status == SolveStatus.OPTIMAL
    assert relative_gap(fo.z, ref.z) < 1e-4
