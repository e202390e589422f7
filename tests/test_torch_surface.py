"""The port's package surface against the JAX package's.

Every public name of ``simplex_tpu`` imports from ``simplex_tpu_torch``
(but ``BlockSparse``, whose counterpart is ``SparseA``);
``simplex_tpu_torch.oracle`` has the reference oracle package's names;
``solve_with_checkpoints`` takes the reference's ``A_host=``; the thesis-order text reader parses as
``simplex_tpu.io.text``'s does (``tests/test_io.py``'s case) and refuses
what it refuses.
"""

import numpy as np
import pytest

import simplex_tpu
import simplex_tpu.oracle as joracle
import simplex_tpu_torch
import simplex_tpu_torch.oracle as toracle
from simplex_tpu.core.checkpoint import solve_with_checkpoints as jax_solve_with_checkpoints
from simplex_tpu.io import text as jtext
from simplex_tpu_torch import SolveStatus, solve_with_checkpoints
from simplex_tpu_torch.io import text
from simplex_tpu_torch.oracle.generator import random_dense_lp

NOT_PORTED = {"BlockSparse"}


@pytest.mark.parametrize("name", sorted(set(simplex_tpu.__all__) - NOT_PORTED))
def test_every_reference_name_imports(name):
    assert name in simplex_tpu_torch.__all__
    assert getattr(simplex_tpu_torch, name) is not None


def test_version_matches():
    assert simplex_tpu_torch.__version__ == simplex_tpu.__version__ == "0.2.0"


def test_oracle_package_names():
    assert set(toracle.__all__) == set(joracle.__all__)
    assert toracle.get_oracle("scipy") is toracle.solve_scipy
    from simplex_tpu_torch.oracle.native import solve_native

    assert toracle.get_oracle("native") is solve_native
    with pytest.raises(ValueError, match="unknown oracle"):
        toracle.get_oracle("glpk")
    with pytest.raises(ValueError, match="unknown oracle"):
        joracle.get_oracle("glpk")
    A, b, c = toracle.random_dense_lp(6, 14, seed=3)
    ref = toracle.solve_scipy(A, b, c)
    assert ref.status == SolveStatus.OPTIMAL
    assert toracle.relative_gap(ref.z, joracle.solve_scipy(A, b, c).z) < 1e-12


def test_solve_with_checkpoints_takes_a_host_copy(tmp_path):
    A, b, c = random_dense_lp(12, 30, seed=4, dtype=np.float32)
    res = solve_with_checkpoints(A, b, c, path=tmp_path / "t.npz", A_host=A, device="cpu")
    ref = jax_solve_with_checkpoints(A, b, c, path=tmp_path / "j.npz", A_host=A)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert res.z == pytest.approx(float(ref.z), rel=1e-6)


def test_thesis_field_order_roundtrip(tmp_path):
    # tests/test_io.py::test_thesis_field_order_roundtrip
    src_text = "2 4  2 1 1 0  1 3 0 1  5 10  3 2 0 0"
    thesis_text = "2 4  3 2 0 0  5 10  2 1 1 0  1 3 0 1"
    A1, b1, c1 = text.loads_lp(src_text)
    A2, b2, c2 = text.loads_lp_thesis(thesis_text)
    for x, y in ((A1, A2), (b1, b2), (c1, c2)):
        np.testing.assert_array_equal(x, y)
    for got, want in zip(text.loads_lp_thesis(thesis_text), jtext.loads_lp_thesis(thesis_text)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    path = tmp_path / "t.txt"
    path.write_text(thesis_text + "\n")
    for got, want in zip(text.load_lp_thesis(path, dtype=np.float64), jtext.load_lp_thesis(path, dtype=np.float64)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float64


@pytest.mark.parametrize("bad", ["", "2", "2 4  3 2 0 0  5 10  2 1 1 0  1 3 0"])
def test_thesis_reader_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as ours:
        text.loads_lp_thesis(bad)
    with pytest.raises(ValueError) as ref:
        jtext.loads_lp_thesis(bad)
    assert str(ours.value) == str(ref.value)
