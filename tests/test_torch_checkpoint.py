"""The port's checkpoint / resume (``simplex_tpu_torch.core.checkpoint``)
against the JAX package's ``simplex_tpu.core.checkpoint``: chunked solves,
interrupted and resumed solves (full and light snapshots), the
validation's refusals, the perturbation drop, one file format for both
packages (a snapshot written by either resumes in the other), sparse A
and the light basis snapshots. Mirrors ``tests/test_checkpoint.py``.

Tolerances: z to rel 1e-5 (the fp32 gate) against the uninterrupted solve
and the other package; a rebuilt inverse to rtol 1e-5 / atol 1e-6 of the
float64 inverse; leaves written and read back exactly.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import simplex_tpu
from simplex_tpu.core import checkpoint as jck
from simplex_tpu.dist import checkpoint2d as jck2d
from simplex_tpu.oracle.generator import degenerate_streak_lp, random_dense_lp
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.core import checkpoint as ck
from simplex_tpu_torch.core.solver import build_problem, solve_state
from simplex_tpu_torch.core.state import initial_state_slack

GAP = 1e-5


def f32(*vs):
    return tuple(np.asarray(v, np.float32) for v in vs)


class Stop(Exception):
    pass


def stop_after(k):
    """An ``on_chunk`` that stops the solve after its k-th snapshot."""
    seen = []

    def on_chunk(state):
        seen.append(int(state.iters))
        if len(seen) == k:
            raise Stop

    return on_chunk


def light_from(monkeypatch, light, m):
    """Light snapshots for an m-row solve when ``light``, full ones else
    (the rule is m >= ``LIGHT_FROM_M``)."""
    monkeypatch.setattr(ck, "LIGHT_FROM_M", m if light else m + 1)


def test_checkpointed_solve_matches_direct(tmp_path):
    A, b, c = f32(*random_dense_lp(24, 60, seed=8))
    direct = solve(A, b, c, device="cpu")
    ckpt = tmp_path / "state.npz"
    chunks = []
    res = ck.solve_with_checkpoints(
        A, b, c, path=ckpt, options=SimplexOptions(checkpoint_every=5),
        on_chunk=lambda s: chunks.append(int(s.iters)), device="cpu",
    )
    assert res.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(direct.z, rel=1e-6)
    assert len(chunks) >= 2 and ckpt.exists()
    ref = jck.solve_with_checkpoints(A, b, c, path=tmp_path / "j.npz",
                                     options=simplex_tpu.SimplexOptions(checkpoint_every=5))
    assert res.z == pytest.approx(ref.z, rel=GAP) and res.iters == ref.iters


@pytest.mark.parametrize("light", [False, True])
def test_resume_from_partial_checkpoint(tmp_path, monkeypatch, light):
    A, b, c = f32(*random_dense_lp(24, 60, seed=9))
    light_from(monkeypatch, light, 24)
    direct = solve(A, b, c, device="cpu")
    ckpt = tmp_path / "state.npz"
    partial = ck.solve_with_checkpoints(
        A, b, c, path=ckpt, options=SimplexOptions(checkpoint_every=4, max_iter=4), device="cpu",
    )
    assert partial.status == SolveStatus.MAX_ITER and partial.iters == 4
    with np.load(ckpt) as data:
        assert ("B_inv" in data.files) == (not light)
    res = ck.solve_with_checkpoints(A, b, c, path=ckpt, options=SimplexOptions(checkpoint_every=50),
                                    device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(direct.z, rel=GAP)
    assert res.iters >= partial.iters


@pytest.mark.parametrize("opts", [
    dict(pricing="steepest", update_defer=4),
    dict(pricing="devex"),
    dict(pricing_dtype="bfloat16", update_defer=4, multi_price=8),
])
def test_interrupted_resume_under_options(tmp_path, opts):
    # a solve stopped after its second snapshot resumes in a fresh call
    A, b, c = f32(*random_dense_lp(32, 80, seed=10))
    options = SimplexOptions(checkpoint_every=3, **opts)
    direct = solve(A, b, c, options=options, device="cpu")
    ckpt = tmp_path / "s.npz"
    with pytest.raises(Stop):
        ck.solve_with_checkpoints(A, b, c, path=ckpt, options=options, on_chunk=stop_after(2),
                                  device="cpu")
    res = ck.solve_with_checkpoints(A, b, c, path=ckpt, options=options, device="cpu")
    assert res.status == direct.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(direct.z, rel=GAP)


def test_validate_rejects_corrupt_checkpoint(tmp_path):
    A, b, c = f32(*random_dense_lp(8, 20, seed=10))
    ckpt = tmp_path / "state.npz"
    ck.solve_with_checkpoints(A, b, c, path=ckpt,
                              options=SimplexOptions(checkpoint_every=2, max_iter=2), device="cpu")
    state = ck.load_checkpoint(ckpt, device="cpu")
    ck.validate_checkpoint(state, A, b)

    def with_basis(i, v):
        basis = state.basis.clone()
        basis[i] = v
        return dataclasses.replace(state, basis=basis)

    with pytest.raises(ValueError, match="out of range"):
        ck.validate_checkpoint(with_basis(0, 9999), A, b)
    with pytest.raises(ValueError, match="duplicate"):
        ck.validate_checkpoint(with_basis(0, int(state.basis[1])), A, b)
    with pytest.raises(ValueError, match="infeasible"):
        ck.validate_checkpoint(dataclasses.replace(state, x_b=state.x_b - 1000.0), A, b)
    with pytest.raises(ValueError, match="A_B x_b = b"):
        ck.validate_checkpoint(dataclasses.replace(state, x_b=state.x_b + 1.0), A, b)
    with pytest.raises(ValueError, match="shape"):
        ck.validate_checkpoint(state, A[:4], b[:4])


@pytest.mark.parametrize("opts", [dict(), dict(pricing="steepest", update_defer=4)])
def test_checkpoint_roundtrip(tmp_path, opts):
    A, b, c = f32(*random_dense_lp(8, 20, seed=11))
    ckpt = tmp_path / "s.npz"
    options = SimplexOptions(checkpoint_every=3, max_iter=3, **opts)
    ck.solve_with_checkpoints(A, b, c, path=ckpt, options=options, device="cpu")
    state = ck.load_checkpoint(ckpt, A=A, device="cpu")
    ck.save_checkpoint(tmp_path / "s2.npz", state)
    state2 = ck.load_checkpoint(tmp_path / "s2.npz", A=A, device="cpu")
    for f in ck._FIELDS:
        a, b2 = getattr(state, f), getattr(state2, f)
        if a is None:
            assert b2 is None, f
        else:
            np.testing.assert_array_equal(a.numpy(), b2.numpy(), err_msg=f)
    assert (state.e is None) == ("pricing" not in opts)


def test_full_save_folds_pending_pairs(tmp_path):
    # pending deferred pairs go into B_inv: the file holds the true inverse,
    # zero pairs and npend = 0, and the state is left as it was
    A, b, c = f32(*random_dense_lp(16, 40, seed=12))
    opts = SimplexOptions(update_defer=8, verify_terminal=False)
    prob = build_problem(A, b, c, opts, "cpu")
    s = initial_state_slack(prob, torch.float32, update_defer=8)
    s = solve_state(prob, s, opts, 5)
    assert int(s.npend) > 0
    B_true = (s.B_inv + s.U.T @ s.R).numpy()
    before = s.U.clone()
    ck.save_checkpoint(tmp_path / "f.npz", s)
    with np.load(tmp_path / "f.npz") as data:
        np.testing.assert_allclose(data["B_inv"], B_true, rtol=1e-6, atol=1e-7)
        assert not data["U"].any() and int(data["npend"]) == 0
        assert data["U"].shape == (8, 16)
    np.testing.assert_array_equal(s.U.numpy(), before.numpy())


def test_light_checkpoint_roundtrip(tmp_path):
    A, b, c = f32(*random_dense_lp(16, 40, seed=12))
    opts = SimplexOptions(verify_terminal=False, update_defer=4)
    prob = build_problem(A, b, c, opts, "cpu")
    state = solve_state(prob, initial_state_slack(prob, torch.float32, update_defer=4), opts, 6)
    ckpt = tmp_path / "light.npz"
    ck.save_checkpoint(ckpt, state, light=True)
    with np.load(ckpt) as data:
        assert "B_inv" not in data.files and "U" not in data.files
        assert tuple(data["_defer_shape"]) == (4, 16)
    loaded = ck.load_checkpoint(ckpt, A=A, b=b, c=c, device="cpu")
    ck.validate_checkpoint(loaded, A, b)
    np.testing.assert_array_equal(loaded.basis.numpy(), state.basis.numpy())
    B_exact = np.linalg.inv(A.astype(np.float64)[:, state.basis.numpy()])
    np.testing.assert_allclose(loaded.B_inv.numpy(), B_exact.astype(np.float32), rtol=1e-5, atol=1e-6)
    assert tuple(loaded.U.shape) == (4, 16) and int(loaded.npend) == 0
    assert int(loaded.last_refac) == int(loaded.iters)
    with pytest.raises(ValueError, match="light checkpoint"):
        ck.load_checkpoint(ckpt, device="cpu")


def test_file_format_matches_jax(tmp_path, monkeypatch):
    # the same state written by both packages: the same keys, shapes and
    # dtypes (the port writes the JAX dummies where its leaves are None)
    A, b, c = f32(*random_dense_lp(12, 30, seed=13))
    for light in (False, True):
        jpath, ppath = tmp_path / f"j{light}.npz", tmp_path / f"p{light}.npz"
        jck.solve_with_checkpoints(A, b, c, path=jpath,
                                   options=simplex_tpu.SimplexOptions(checkpoint_every=3, max_iter=3))
        js = jck.load_checkpoint(jpath)
        jck.save_checkpoint(jpath, js, light=light)
        light_from(monkeypatch, light, 12)
        ck.solve_with_checkpoints(A, b, c, path=ppath, device="cpu",
                                  options=SimplexOptions(checkpoint_every=3, max_iter=3))
        with np.load(jpath) as j, np.load(ppath) as p:
            assert sorted(j.files) == sorted(p.files), light
            for f in j.files:
                assert (j[f].shape, j[f].dtype) == (p[f].shape, p[f].dtype), (light, f)
            np.testing.assert_array_equal(j["basis"], p["basis"])


@pytest.mark.parametrize("light", [False, True])
def test_resume_across_packages(tmp_path, monkeypatch, light):
    # a tie-free instance: a snapshot from one package resumes in the other
    # to the same status and z, both ways
    A, b, c = f32(*random_dense_lp(40, 100, seed=5))
    direct = solve(A, b, c, device="cpu")
    jopts = simplex_tpu.SimplexOptions(checkpoint_every=7)
    opts = SimplexOptions(checkpoint_every=7)
    light_from(monkeypatch, light, 40)

    path = tmp_path / "port.npz"
    with pytest.raises(Stop):
        ck.solve_with_checkpoints(A, b, c, path=path, options=opts, on_chunk=stop_after(2),
                                  device="cpu")
    jres = jck.solve_with_checkpoints(A, b, c, path=path, options=jopts)

    path = tmp_path / "jax.npz"
    with pytest.raises(Stop):
        jck.solve_with_checkpoints(A, b, c, path=path, options=jopts, on_chunk=stop_after(2))
    if light:
        state = jck.load_checkpoint(path)
        jck.save_checkpoint(path, state, light=True)
    pres = ck.solve_with_checkpoints(A, b, c, path=path, options=opts, device="cpu")
    for r in (jres, pres):
        assert int(r.status) == SolveStatus.OPTIMAL
        assert r.z == pytest.approx(direct.z, rel=GAP)
    assert jres.iters == pres.iters == direct.iters


def test_perturbation_is_dropped_before_a_snapshot(tmp_path):
    # a chunk that ends with the rhs shift armed writes the unshifted point:
    # every snapshot satisfies A_B x_b = b
    A, b, c = f32(*degenerate_streak_lp(24, 60, seed=5))
    opts = SimplexOptions(checkpoint_every=3, perturb_after=2, bland_after=0)
    seen = []

    def on_chunk(state):
        assert state.pert is None or not bool(state.pert.on)
        seen.append(1)
        ck.validate_checkpoint(ck.load_checkpoint(tmp_path / "p.npz", device="cpu"), A, b, tol=1e-4)

    res = ck.solve_with_checkpoints(A, b, c, path=tmp_path / "p.npz", options=opts,
                                    on_chunk=on_chunk, device="cpu")
    direct = solve(A, b, c, device="cpu")
    assert len(seen) >= 2
    assert res.status == direct.status
    if res.status == SolveStatus.OPTIMAL:
        assert res.z == pytest.approx(direct.z, rel=GAP)


@pytest.mark.parametrize("light", [False, True])
def test_checkpointed_sparse_solve(tmp_path, monkeypatch, light):
    A, b, c = f32(*random_dense_lp(24, 60, seed=14))
    light_from(monkeypatch, light, 24)
    A[:, :36][np.random.default_rng(1).uniform(size=(24, 36)) > 0.4] = 0.0
    direct = solve(A, b, c, device="cpu")
    path = tmp_path / "sp.npz"
    opts = SimplexOptions(checkpoint_every=4)
    with pytest.raises(Stop):
        ck.solve_with_checkpoints(sps.csc_matrix(A), b, c, path=path, options=opts,
                                  on_chunk=stop_after(2), device="cpu")
    res = ck.solve_with_checkpoints(sps.csc_matrix(A), b, c, path=path, options=opts, device="cpu")
    assert res.status == direct.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(direct.z, rel=GAP)


def test_light_snapshots_match_jax(tmp_path):
    basis = np.array([3, 0, 5, 1], np.int32)
    ck.save_light_snapshot(tmp_path / "p.npz", basis, 17, 2, int(SolveStatus.RUNNING))
    jck2d.save_light_snapshot(tmp_path / "j.npz", basis, 17, 2, int(SolveStatus.RUNNING))
    for path in ("p.npz", "j.npz"):
        got = ck.load_light_snapshot(tmp_path / path, 4, 6)
        want = jck2d.load_light_snapshot(tmp_path / path, 4, 6)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (17, 2)
    with pytest.raises(ValueError, match="shape"):
        ck.load_light_snapshot(tmp_path / "p.npz", 5, 6)
    with pytest.raises(ValueError, match="out of range"):
        ck.load_light_snapshot(tmp_path / "p.npz", 4, 5)
    ck.save_light_snapshot(tmp_path / "d.npz", np.array([1, 1, 2, 3]), 0, 0, 0)
    with pytest.raises(ValueError, match="duplicate"):
        ck.load_light_snapshot(tmp_path / "d.npz", 4, 6)


def test_jax_dummies_read_as_none(tmp_path):
    A, b, c = f32(*random_dense_lp(8, 20, seed=15))
    path = tmp_path / "j.npz"
    jck.solve_with_checkpoints(A, b, c, path=path,
                               options=simplex_tpu.SimplexOptions(checkpoint_every=2, max_iter=2))
    s = ck.load_checkpoint(path, A=A, device="cpu")
    assert s.e is None and s.gamma is None and s.U is None and s.R is None and s.npend is None
    js = jck.load_checkpoint(path)
    np.testing.assert_array_equal(s.B_inv.numpy(), np.asarray(js.B_inv))
    assert int(s.iters) == int(js.iters) == 2
