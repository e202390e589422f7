"""The port's io copies (MPS read / write, canonical form) and its CLI
against the JAX package's, on every MPS file in ``tests/data``.

Readers must agree exactly (same parser on the same text); the CLIs must
print the same optimum line (``%g`` of the objective in the instance's own
sense) and exit with the same code, with and without ``--presolve``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse

from simplex_tpu import cli as jcli
from simplex_tpu.io import canonical as jcanon
from simplex_tpu.io import mps as jmps
from simplex_tpu_torch import cli, read_mps, write_mps
from simplex_tpu_torch.io import canonical
from simplex_tpu_torch.io.mps import mps_to_canonical
from simplex_tpu_torch.oracle.generator import production_lp

DATA = Path(__file__).parent / "data"
MPS_FILES = sorted(p.name for p in DATA.glob("*.mps"))


def assert_same_problem(t, j):
    for f in ("name", "maximize", "row_names", "row_types", "col_names", "c0"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("A", "b", "c", "lower", "upper"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.integer is None) == (j.integer is None)
    if t.integer is not None:
        np.testing.assert_array_equal(t.integer, j.integer)


@pytest.mark.parametrize("name", MPS_FILES)
def test_read_mps_matches_jax(name):
    t, j = read_mps(DATA / name), jmps.read_mps(DATA / name)
    assert_same_problem(t, j)
    ts = read_mps(DATA / name, sparse=True)
    assert scipy.sparse.issparse(ts.A)
    np.testing.assert_array_equal(ts.A.toarray(), t.A)


def test_write_mps_round_trip(tmp_path):
    lp = production_lp(6, 4, seed=3)
    lower = lp.lower.copy()
    upper = lp.upper.copy()
    lower[1], upper[1] = -np.inf, np.inf  # FR
    lower[2] = -np.inf  # MI + UP
    lower[3] = upper[3] = 2.5  # FX
    upper[4] = np.inf  # LO only
    row_types = ["L", "G", "E", "L"]
    path = tmp_path / "rt.mps"
    write_mps(path, lp.A, lp.b, lp.c, row_types, maximize=True, lower=lower, upper=upper,
              c0=1.25, name="RT")
    t, j = read_mps(path), jmps.read_mps(path)
    assert_same_problem(t, j)
    assert t.maximize and t.c0 == 1.25 and t.row_types == row_types
    np.testing.assert_array_equal(t.A, lp.A)
    np.testing.assert_array_equal(t.b, lp.b)
    np.testing.assert_array_equal(t.c, lp.c)
    np.testing.assert_array_equal(t.lower, lower)
    np.testing.assert_array_equal(t.upper, upper)


def test_canonical_forms_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    A, b, c = rng.uniform(0.1, 1, (3, 5)), rng.uniform(1, 2, 3), rng.uniform(0, 1, 5)
    path = tmp_path / "ineq.mps"
    write_mps(path, A, b, c, ["L"] * 3)
    got = mps_to_canonical(read_mps(path))
    want = jmps.mps_to_canonical(jmps.read_mps(path))
    for f in ("A", "b", "c", "basis0"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.n_structural == want.n_structural == 5
    with pytest.raises(ValueError):
        canonical.from_inequalities(A, -b, c)
    lp = production_lp(6, 4, seed=3)
    eq, jeq = canonical.to_equality_form(lp), jcanon.to_equality_form(lp)
    for f in ("A", "b", "c", "u"):
        np.testing.assert_array_equal(getattr(eq, f), getattr(jeq, f), err_msg=f)
    assert eq.k_transformed == jeq.k_transformed and eq.z_const == jeq.z_const
    xp = rng.uniform(0, 1, eq.k_transformed)
    np.testing.assert_array_equal(eq.recover(xp), jeq.recover(xp))
    assert not hasattr(canonical, "pad_columns")


def first_line(out: str) -> str:
    return next(line for line in out.splitlines() if not line.startswith(("\t", " ")))


@pytest.mark.parametrize("presolve", [False, True])
@pytest.mark.parametrize("name", MPS_FILES)
def test_cli_matches_jax_cli(name, presolve, capsys):
    extra = ["--presolve"] if presolve else []
    rc = cli.main(["solve", str(DATA / name), "--device", "cpu", "--backend", "torch", *extra])
    out = capsys.readouterr().out
    rc_j = jcli.main(["solve", str(DATA / name), "--cpu", *extra])
    out_j = capsys.readouterr().out
    assert rc == rc_j
    assert first_line(out) == first_line(out_j)
    if rc == 0:
        assert "Pivots:" in out


def test_cli_flags(capsys):
    mps = str(DATA / "prod_bounded.mps")
    rc = cli.main(["solve", mps, "--device", "cpu", "--fast", "--partial-pricing", "0",
                   "--time", "--max-iter", "500"])
    out = capsys.readouterr().out
    assert rc == 0 and "Optimum found: 15.25" in out and "Solve:" in out
    # --sparse solves (ported), and so does --algo pdhg (with --crossover
    # the exact vertex)
    rc = cli.main(["solve", mps, "--device", "cpu", "--sparse"])
    assert rc == 0 and "Optimum found: 15.25" in capsys.readouterr().out
    assert cli.main(["solve", mps, "--device", "cpu", "--algo", "pdhg", "--crossover"]) == 0
    assert "Optimum found: 15.25" in capsys.readouterr().out
    assert cli.main(["solve", str(DATA / "nonexistent.mps"), "--device", "cpu"]) == 1


def test_resolve_flag_defaults():
    ns = cli.argparse.Namespace
    fast = ns(fast=True, pricing_dtype=None, update_defer=0, partial_pricing=None,
              refactor_every=None, multi_price=None)
    cli._resolve_flag_defaults(fast)
    assert (fast.pricing_dtype, fast.update_defer, fast.partial_pricing,
            fast.refactor_every, fast.multi_price) == ("bfloat16", 0, 8, 1024, 64)
    plain = ns(fast=False, pricing_dtype=None, update_defer=None, partial_pricing=None,
               refactor_every=None, multi_price=None)
    cli._resolve_flag_defaults(plain)
    assert (plain.pricing_dtype, plain.update_defer, plain.partial_pricing,
            plain.refactor_every, plain.multi_price) == ("float32", 0, 0, 0, 0)


def test_new_modules_leave_jax_out():
    code = (
        "import sys, simplex_tpu_torch, simplex_tpu_torch.cli, simplex_tpu_torch.presolve, "
        "simplex_tpu_torch.logging, simplex_tpu_torch.core.twophase, "
        "simplex_tpu_torch.io.mps, simplex_tpu_torch.io.mps_write, "
        "simplex_tpu_torch.io.canonical, simplex_tpu_torch.oracle.generator, "
        "simplex_tpu_torch.oracle.reference, simplex_tpu_torch.bench.profile_general, "
        "simplex_tpu_torch.batch.vmapped, simplex_tpu_torch.batch.step, "
        "simplex_tpu_torch.batch.dual, simplex_tpu_torch.fo, simplex_tpu_torch.fo.pdhg, "
        "simplex_tpu_torch.fo.crossover\n"
        "from simplex_tpu_torch import cli\n"
        "cli.main(['solve', 'tests/data/prod_bounded.mps', '--device', 'cpu'])\n"
        "cli.main(['solve', 'tests/data/sample.txt', '--device', 'cpu', '--algo', 'pdhg', '--crossover'])\n"
        "import numpy as np\n"
        "A, b, c = simplex_tpu_torch.load_lp('tests/data/sample.txt')\n"
        "r = simplex_tpu_torch.solve_batched(A[None], b[None], c[None], device='cpu')\n"
        "assert int(r.status[0]) == 1 and abs(float(r.z[0]) - 9) < 1e-5\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'simplex_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'simplex_tpu' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=DATA.parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert "Optimum found: 15.25" in proc.stdout and "Optimum found: 9" in proc.stdout
