"""The generator's recipe, the frozen byte counts, and the float64
reference against the port's own state (``backend="torch"``) at a small
size on the CPU."""

import pytest
import torch

from benchmark import generate, roofline
from benchmark.reference import lowprec
from benchmark.reference import simplex64 as ref64

CFG = {"m": 24, "n": 80, "dtype": "float32", "column_block": 16}


def test_recipe_holds():
    A, b, c = generate.dense_canonical(CFG, 2**33 + 5, "cpu")
    m, n = CFG["m"], CFG["n"]
    assert torch.equal(A[:, n - m :], torch.eye(m))
    assert float(A[:, : n - m].min()) >= 0.1 and float(A[:, : n - m].max()) <= 1.0
    assert float(b.min()) >= 1.0 and float(b.max()) <= 2.0
    assert float(c[: n - m].min()) >= 0.1 and float(c[: n - m].max()) <= 1.0
    assert torch.equal(c[n - m :], torch.zeros(m))


def test_same_seed_same_inputs_any_split():
    A, b, c = generate.dense_canonical(CFG, 7, "cpu")
    again = generate.dense_canonical(CFG, 7, "cpu")
    assert all(torch.equal(x, y) for x, y in zip((A, b, c), again))
    for lo, hi in ((0, 16), (5, 37), (40, 80), (50, 61)):
        part, _, _ = generate.dense_canonical(CFG, 7, "cpu", lo, hi)
        assert torch.equal(part, A[:, lo:hi])
    other, _, _ = generate.dense_canonical(CFG, 8, "cpu")
    assert not torch.equal(other, A)


def test_frozen_byte_counts_are_the_hand_counts():
    mib = 2**20
    # A's 8192 x 16384 floats once, y and the basis (m each), c (n), the choice
    assert roofline.kernel("pricing_scan").nbytes(8192, 16384, 4) == 512 * mib + 4 * (2 * 8192 + 16384) + 16
    # a rank's 32768 x 32768 shard of the four-card configuration
    assert roofline.kernel("pricing_scan").nbytes(32768, 32768, 4) == 4096 * mib + 4 * (3 * 32768) + 16
    # B_inv read and written once, eta and the row read
    assert roofline.kernel("rank1_update").nbytes(8192, 8192, 4) == 512 * mib + 8 * 8192
    assert roofline.kernel("rank1_update").nbytes(32768, 32768, 4) == 8192 * mib + 8 * 32768
    assert roofline.bound_s(512 * mib, 0, 67e12) == pytest.approx(512 * mib / 3.35e12)


@pytest.mark.parametrize("pricing", ["dantzig", "steepest"])
def test_reference_agrees_with_the_ports_state(pricing):
    """Pivots of the port's plain backend from the slack basis, judged
    against the float64 reference: the same inverse, x_b and y, each pick
    the rule's best and each step feasible."""
    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.core import solver
    from simplex_tpu_torch.core.state import initial_state_slack

    A, b, c = generate.dense_canonical(CFG, 11, "cpu")
    opts = SimplexOptions(backend="torch", pricing=pricing)
    prob = solver.build_problem(A, b, c, opts, "cpu")
    s = initial_state_slack(prob, torch.float32, perturb=True, pricing=pricing)
    src = ref64.tensor_source(A, block=16)
    for k in range(6):
        before = s.basis.clone()
        s = solver.solve_state(prob, s, opts, k + 1)
        s.status = torch.zeros_like(s.status)
        p, q = ref64.entering_leaving(before, s.basis)
        ref0 = ref64.Basis(src, b, c, before)
        assert ref64.pricing_gap(ref0, p, pricing) < 1e-6
        assert ref64.ratio_gap(ref0, ref0.solve(ref0.column(p)), q, opts.pivot_tol) < 1e-6
        ref1 = ref64.Basis(src, b, c, s.basis)
        assert ref64.xb_err(ref1, s.x_b) < 1e-5
        assert ref64.y_err(ref1, s.y) < 1e-5
        assert ref64.binv_err(ref1, s.B_inv) < 1e-5
        # a pick the rule would not make is seen
        worst = int(torch.argmax(torch.where(torch.isfinite(ref0.reduced_costs()), ref0.reduced_costs(), -1e9)))
        assert ref64.pricing_gap(ref0, worst, "dantzig") > 1e-3


def test_control_is_kinder_than_bf16_and_wrong_by_its_rounding():
    A, b, c = generate.dense_canonical({**CFG, "m": 64, "n": 192}, 3, "cpu")
    src = ref64.tensor_source(A, block=64)
    basis = torch.arange(192 - 64, 192)
    basis[:10] = torch.arange(10)
    ref = ref64.Basis(src, b, c, basis)
    ctl = lowprec.Control(ref)
    assert 1e-4 < ref64.xb_err(ref, ctl.x) < 0.5
    assert 1e-4 < ref64.binv_err(ref, ctl.inv)
    assert ref64.xb_err(ref, ref.x) < 1e-12
