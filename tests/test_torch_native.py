"""The port's native helpers against the JAX package's.

``simplex_tpu_torch.io.native`` (``load_lp_fast`` / ``save_lp_fast``) and
``simplex_tpu_torch.oracle.native`` (``solve_native``) against
``simplex_tpu.io.native`` / ``simplex_tpu.oracle.native`` and the Python
parser, on ``tests/data`` and ``random_dense_lp`` (the cases of
``tests/test_io.py`` and ``tests/test_oracle.py``): the loaders give the
same arrays bit for bit; the two oracles run the same f64 source, so z
agrees to 1e-12 and both to HiGHS within 1e-9 (``tests/test_oracle.py``'s
bar). Both libraries build with g++ under ``build/native/``, never in the
package tree; without a compiler the loader falls back to the Python
parser. ``verify --oracle native`` through the CLI.
"""

import logging
from pathlib import Path

import numpy as np
import pytest

from simplex_tpu.io.native import load_lp_fast as jax_load_lp_fast
from simplex_tpu.oracle.generator import random_dense_lp
from simplex_tpu.oracle.native import solve_native as jax_solve_native
from simplex_tpu_torch import SolveStatus, cli, native_build, solve
from simplex_tpu_torch.io import native as io_native
from simplex_tpu_torch.io.text import load_lp, loads_lp
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.oracle import native as oracle_native
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

DATA = Path(__file__).parent / "data"
SAMPLE = str(DATA / "sample.txt")
PKG = Path(io_native.__file__).resolve().parents[1]


def test_loader_matches_python_and_jax(tmp_path):
    A, b, c = random_dense_lp(17, 43, seed=6)  # odd shapes on purpose
    p = tmp_path / "lp.txt"
    io_native.save_lp_fast(p, A, b, c)
    A1, b1, c1 = io_native.load_lp_fast(p)
    A2, b2, c2 = loads_lp(p.read_text())
    A3, b3, c3 = jax_load_lp_fast(p)
    for x, y, z in ((A1, A2, A3), (b1, b2, b3), (c1, c2, c3)):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    np.testing.assert_allclose(A1, A, atol=1e-6)


def test_loader_on_the_sample_and_garbage(tmp_path):
    A, b, c = io_native.load_lp_fast(SAMPLE)  # prose after the numbers
    np.testing.assert_array_equal(A, [[1, 1, 1, 0], [2, 1, 0, 1]])
    for x, y in zip((A, b, c), load_lp(SAMPLE)):
        np.testing.assert_array_equal(x, y)
    bad = tmp_path / "bad.txt"
    bad.write_text("2 4\n1 2 3\n")  # not enough numbers
    with pytest.raises(ValueError):
        io_native.load_lp_fast(bad)
    hdr = tmp_path / "hdr.txt"
    hdr.write_text("notanumber\n")
    with pytest.raises(ValueError):
        io_native.load_lp_fast(hdr)


def test_builds_go_under_build_not_the_package():
    for src in (io_native.SRC, oracle_native.SRC):
        lib = native_build.build(src)
        assert lib.exists() and lib.parent == native_build.BUILD_DIR
        assert PKG not in lib.parents
        assert lib == native_build.library_path(src)  # a second build reuses it
    assert not list(PKG.rglob("*.so"))


def test_loader_falls_back_without_a_compiler(monkeypatch, tmp_path):
    """No g++: the Python parser and writer, and one warning in the log."""
    monkeypatch.setattr(io_native, "_lib", None)
    monkeypatch.setattr(io_native, "_build_failed", False)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    log = get_logger("io")
    log.addHandler(handler)
    try:
        A, b, c = io_native.load_lp_fast(SAMPLE)
        p = tmp_path / "out.txt"
        io_native.save_lp_fast(p, A, b, c)
    finally:
        log.removeHandler(handler)
    np.testing.assert_array_equal(A, [[1, 1, 1, 0], [2, 1, 0, 1]])
    for x, y in zip((A, b, c), loads_lp(p.read_text())):
        np.testing.assert_array_equal(x, y)
    assert sum("using the Python parser" in msg for msg in seen) == 1


def test_oracle_golden_and_unbounded():
    A = np.array([[1.0, 1, 1, 0], [2, 1, 0, 1]])
    res = oracle_native.solve_native(A, np.array([4.0, 5]), np.array([3.0, 2, 0, 0]))
    assert res.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(9.0, abs=1e-12)
    np.testing.assert_allclose(res.x, [1, 3, 0, 0], atol=1e-12)
    res = oracle_native.solve_native(np.array([[-1.0, 1.0, 1.0]]), np.array([1.0]), np.array([1.0, 0.0, 0.0]))
    assert res.status == SolveStatus.UNBOUNDED and res.z is None and res.x is None


@pytest.mark.parametrize("m,n,seed", [(8, 20, 0), (32, 80, 1), (64, 160, 2)])
def test_oracle_matches_jax_and_highs(m, n, seed):
    A, b, c = random_dense_lp(m, n, seed=seed, dtype=np.float64)
    res = oracle_native.solve_native(A, b, c)
    jres = jax_solve_native(A, b, c)
    ref = solve_scipy(A, b, c)
    assert res.status == jres.status == SolveStatus.OPTIMAL
    assert abs(res.z - jres.z) <= 1e-12 * (1 + abs(jres.z))
    assert relative_gap(res.z, ref.z) < 1e-9
    # and the port's fp32 solve against it (tests/test_oracle.py's bar)
    ours = solve(A.astype(np.float32), b.astype(np.float32), c.astype(np.float32), device="cpu")
    assert relative_gap(ours.z, res.z) < 1e-5


def test_oracle_from_a_basis():
    A, b, c = random_dense_lp(12, 30, seed=3, dtype=np.float64)
    cold = oracle_native.solve_native(A, b, c)
    basis = np.flatnonzero(cold.x > 1e-9)
    assert basis.size <= 12
    res = oracle_native.solve_native(A, b, c, basis0=np.arange(18, 30))
    assert res.z == pytest.approx(cold.z, rel=1e-12)


def test_cli_verify_with_the_native_oracle(capsys):
    rc = cli.main(["verify", SAMPLE, "--oracle", "native", "--device", "cpu", "--backend", "torch"])
    out = capsys.readouterr().out
    assert rc == 0 and "ours=9 oracle=9 rel_gap=0.000e+00 (OK @ 1e-06)" in out
    # a general-route input is held against HiGHS on its general form
    rc = cli.main(["verify", str(DATA / "prod_bounded.mps"), "--oracle", "native", "--device", "cpu",
                   "--backend", "torch"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK @" in out
    # the CLI reads text through the native loader
    rc = cli.main(["solve", SAMPLE, "--device", "cpu", "--backend", "torch"])
    assert rc == 0 and "Optimum found: 9" in capsys.readouterr().out
