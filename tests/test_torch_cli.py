"""The port's CLI subcommands ``verify``, ``analyze`` and ``trace`` against
the JAX package's ``simplex_tpu.cli`` on the same files: exit codes and the
lines that carry numbers; ``NotImplementedError`` from any subcommand
printed as ``error: ...`` with exit code 1; ``--sparse`` against the dense
route. Mirrors ``tests/test_cli.py``.

Tolerances: exit codes and printed text exactly where both packages print
the same format (the objective with ``%g``, the trace's lines).
"""

import io
import re
from pathlib import Path

import numpy as np
import pytest

from simplex_tpu import cli as jcli
from simplex_tpu_torch import cli

DATA = Path("tests/data")
SAMPLE = str(DATA / "sample.txt")
MPS = sorted(p.name for p in DATA.glob("*.mps"))
CPU = ["--device", "cpu"]


def run(capsys, argv, jax=False):
    rc = (jcli.main([*argv, "--cpu"]) if jax else cli.main([*argv, *CPU]))
    out = capsys.readouterr()
    return rc, out.out, out.err


def first_line(text):
    return next((ln for ln in text.splitlines() if ln.strip()), "")


NUM = re.compile(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf)")


def assert_same_report(out, out_j):
    """The same text with the numbers equal to rel / abs 1e-5 (fp32 values
    printed with %g can differ in their last digit)."""
    assert NUM.sub("#", out).split() == NUM.sub("#", out_j).split()
    got = [float(x) for x in NUM.findall(out)]
    want = [float(x) for x in NUM.findall(out_j)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sub", ["verify", "analyze", "trace"])
def test_subcommands_on_the_sample(capsys, sub):
    rc, out, _ = run(capsys, [sub, SAMPLE])
    rc_j, out_j, _ = run(capsys, [sub, SAMPLE], jax=True)
    assert rc == rc_j == 0
    if sub == "trace":
        # the JAX print_trace writes to the stdout of its import time, which
        # capsys does not see: take its report into a buffer instead
        from simplex_tpu.core.trace import print_trace
        from simplex_tpu.io.text import load_lp

        buf = io.StringIO()
        print_trace(*load_lp(SAMPLE), file=buf)
        out_j = buf.getvalue()
    assert_same_report(out, out_j)


def test_verify_reports_the_gap(capsys):
    rc, out, _ = run(capsys, ["verify", SAMPLE, "--gap", "1e-9"])
    assert rc == 0 and "ours=9 oracle=9 rel_gap=0.000e+00 (OK @ 1e-09)" in out


@pytest.mark.parametrize("name", MPS)
def test_verify_and_analyze_mps_match_jax(capsys, name):
    path = str(DATA / name)
    for argv in (["verify", path], ["analyze", path, "--reoptimize", "0=0.1"]):
        rc, out, _ = run(capsys, argv)
        rc_j, out_j, _ = run(capsys, argv, jax=True)
        assert rc == rc_j, (argv, out, out_j)
        if argv[0] == "analyze":
            assert first_line(out) == first_line(out_j)
        elif rc == 0:
            assert "OK" in out or "status agreed" in out


def test_trace_refuses_a_general_input(capsys):
    rc, _, err = run(capsys, ["trace", str(DATA / "prod_bounded.mps")])
    rc_j, _, err_j = run(capsys, ["trace", str(DATA / "prod_bounded.mps")], jax=True)
    assert rc == rc_j == 1
    assert err.strip().splitlines()[-1] == err_j.strip().splitlines()[-1]


def test_analyze_reoptimize_sample(capsys):
    rc, out, _ = run(capsys, ["analyze", SAMPLE, "--reoptimize", "0=0.5"])
    rc_j, out_j, _ = run(capsys, ["analyze", SAMPLE, "--reoptimize", "0=0.5"], jax=True)
    assert rc == rc_j == 0
    assert_same_report(out, out_j)
    assert "inside the allowable range" in out
    rc, _, err = run(capsys, ["analyze", SAMPLE, "--reoptimize", "zero=1"])
    assert rc == 1 and "bad --reoptimize spec" in err


@pytest.mark.parametrize(
    "argv",
    [
        ["verify", SAMPLE, "--pricing", "steepest", "--multi-price", "8"],
        ["verify", SAMPLE, "--algo", "pdhg"],
        ["analyze", SAMPLE, "--algo", "pdhg"],
        ["trace", SAMPLE, "--algo", "pdhg"],
        ["verify", str(DATA / "prod_bounded.mps"), "--pricing", "steepest", "--multi-price", "8"],
    ],
)
def test_not_implemented_exits_1(capsys, argv):
    rc, out, err = run(capsys, argv)
    assert rc == 1 and out == ""
    # steepest edge does not compose with multiple pricing (canonical and
    # general route alike); --algo pdhg runs under solve only, as in the
    # JAX CLI. (The native oracle these cases once named is ported:
    # tests/test_torch_native.py.)
    want = "does not compose" if "--multi-price" in argv else "runs under `solve` only"
    assert err.startswith("error: ") and want in err


def test_sparse_needs_mps(capsys):
    for sub in ("solve", "analyze"):
        rc, _, err = run(capsys, [sub, SAMPLE, "--sparse"])
        assert rc == 1 and "--sparse requires an MPS input" in err


@pytest.mark.parametrize("name", MPS)
def test_solve_sparse_matches_dense(capsys, name):
    path = str(DATA / name)
    rc_d, out_d, _ = run(capsys, ["solve", path])
    rc_s, out_s, _ = run(capsys, ["solve", path, "--sparse"])
    rc_j, out_j, _ = run(capsys, ["solve", path, "--sparse"], jax=True)
    assert rc_s == rc_d == rc_j
    assert first_line(out_s) == first_line(out_d) == first_line(out_j)


def test_analyze_sparse_general(capsys):
    path = str(DATA / "blend_ranges.mps")
    rc, out, _ = run(capsys, ["analyze", path, "--sparse", "--reoptimize", "0=0.1"])
    rc_d, out_d, _ = run(capsys, ["analyze", path, "--reoptimize", "0=0.1"])
    assert rc == rc_d == 0
    assert first_line(out) == first_line(out_d)
    assert [ln for ln in out.splitlines() if "re-solve" in ln] == [
        ln for ln in out_d.splitlines() if "re-solve" in ln]


def test_options_reach_every_subcommand(capsys):
    # the lifted option flags: steepest edge and the flagship set through
    # trace and verify
    rc, out, _ = run(capsys, ["trace", SAMPLE, "--pricing", "steepest", "--verbose"])
    assert rc == 0 and "basis:" in out and "Optimum found." in out
    rc, out, _ = run(capsys, ["verify", SAMPLE, "--fast", "--backend", "torch"])
    assert rc == 0 and "OK" in out
    rc, out, _ = run(capsys, ["verify", SAMPLE, "--fp64", "--backend", "torch"])
    assert rc == 0 and "OK" in out
