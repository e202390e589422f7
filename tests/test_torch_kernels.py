"""The port's kernel ops against the JAX package's, op by op.

Each plain PyTorch version (``simplex_tpu_torch.kernels.ops`` and the
``*_plain`` functions beside the Hopper wrappers) is held against the Pallas
kernel in interpret mode where its shapes tile, and against
``simplex_tpu.kernels.xla`` elsewhere, on the same numpy-seeded inputs. The
Hopper wrappers are called with CPU tensors, which must route to the plain
versions without building or loading the CUDA library. The CUDA kernels
themselves are checked on the card by ``chip_smoke.py``.

Tolerances: indices and flags must match exactly; reduced costs to rtol
1e-5 (fp32 sums in another order); the ratio test's values, eta and x_b
to rtol 1e-6 (the same elementwise fp32 ops on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.kernels import pallas_ops as pk
from simplex_tpu.kernels import xla as xk
from simplex_tpu_torch.kernels import _build, hopper, ops


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))) for a in arrays]


@pytest.fixture
def no_library(monkeypatch):
    """Fail any attempt to build or load the CUDA library."""

    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    hopper.reset_launches()
    yield
    assert set(hopper.launches) == {
        "pricing_scan", "ratio_argmin", "ratio_eta", "rank1_update",
        "batch_pricing", "batch_tail", "batch_rank1",
    }
    assert not any(hopper.launches.values()), hopper.launches


@pytest.mark.parametrize("m,n", [(8, 128), (16, 256), (128, 1024)])
def test_pricing_scan_plain_matches_pallas(m, n, no_library):
    y, A, c = rand((m,), 0), rand((m, n), 1), rand((n,), 2)
    (yj, yt), (Aj, At), (cj, ct) = both(y, A, c)
    eps = 1e-6
    min_j, p_j, neg_j = pk.pricing_scan(yj, Aj, cj, eps)
    for fn in (hopper.pricing_scan_plain, hopper.pricing_scan):
        min_t, p_t, neg_t = fn(yt, At, ct, eps)
        np.testing.assert_allclose(float(min_t), float(min_j), rtol=1e-5)
        assert int(p_t) == int(p_j)
        assert int(neg_t) == int(neg_j)


@pytest.mark.parametrize("m,n", [(7, 130), (33, 257), (1, 5)])
def test_pricing_scan_odd_shapes_match_xla(m, n, no_library):
    y, A, c = rand((m,), 3), rand((m, n), 4), rand((n,), 5)
    (yj, _), (Aj, At), (cj, ct) = both(y, A, c)
    e = np.asarray(xk.reduced_costs(yj, Aj, cj))
    eps = 0.5
    min_t, p_t, neg_t = hopper.pricing_scan(torch.from_numpy(y), At, ct, eps)
    np.testing.assert_allclose(float(min_t), e.min(), rtol=1e-5)
    assert int(p_t) == int(e.argmin())
    negs = np.nonzero(e < -eps)[0]
    assert int(neg_t) == (int(negs[0]) if len(negs) else hopper.INT_MAX)


def test_pricing_scan_tie_break_lowest_index(no_library):
    m, n = 8, 256
    c = np.zeros(n, np.float32)
    c[40] = c[200] = 5.0  # two equal minima of e = -c
    y, A = np.zeros(m, np.float32), np.zeros((m, n), np.float32)
    _, p_j, _ = pk.pricing_scan(jnp.asarray(y), jnp.asarray(A), jnp.asarray(c), 1e-6)
    _, p_t, neg_t = hopper.pricing_scan(
        torch.from_numpy(y), torch.from_numpy(A), torch.from_numpy(c), 1e-6
    )
    assert int(p_j) == int(p_t) == int(neg_t) == 40


@pytest.mark.parametrize("bland", [False, True])
def test_choose_entering_matches_xla(bland, no_library):
    m, n = 16, 200
    y, A, c = rand((m,), 6), rand((m, n), 7), rand((n,), 8)
    (yj, yt), (Aj, At), (cj, ct) = both(y, A, c)
    p_j, min_j = xk.choose_entering(yj, Aj, cj, 1e-5, jnp.asarray(bland))
    for fn in (ops.choose_entering, hopper.choose_entering):
        p_t, min_t = fn(yt, At, ct, 1e-5, torch.tensor(bland))
        assert int(p_t) == int(p_j)
        assert p_t.dtype == torch.int32
        np.testing.assert_allclose(float(min_t), float(min_j), rtol=1e-5)


def test_mask_basic_and_gathers_match_xla():
    m, n = 6, 20
    A, c = rand((m, n), 9), rand((n,), 10)
    basis = np.array([3, 19, 0, 7, 12, 5], np.int32)
    (Aj, At), (cj, ct), (bj, bt) = both(A, c, basis)
    np.testing.assert_array_equal(
        ops.mask_basic(ct, bt).numpy(), np.asarray(xk.mask_basic(cj, bj))
    )
    p = torch.tensor(7, dtype=torch.int32)
    np.testing.assert_array_equal(ops.gather_column(At, p).numpy(), A[:, 7])
    assert float(ops.gather_cost(ct, p)) == float(c[7])
    np.testing.assert_array_equal(
        ops.gather_basis_matrix(At, bt).numpy(),
        np.asarray(xk.gather_basis_matrix(Aj, bj)),
    )
    x = rand((n,), 17)
    np.testing.assert_allclose(
        ops.matvec(At, torch.from_numpy(x)).numpy(),
        np.asarray(xk.matvec(Aj, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6,
    )


def ratio_inputs(m, seed, unbounded=False):
    rng = np.random.default_rng(seed)
    x_b = rng.uniform(0, 1, m).astype(np.float32)
    x_b[::5] = 0.0  # exact ratio ties at theta = 0
    alpha = rng.uniform(-1, 1, m).astype(np.float32)
    if unbounded:
        alpha = -np.abs(alpha) - 0.1
    basis = rng.permutation(m).astype(np.int32)
    return x_b, alpha, basis


@pytest.mark.parametrize("m", [7, 128, 300])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("unbounded", [False, True])
def test_ratio_tests_match_xla(m, bland, unbounded):
    (xj, xt), (aj, at), (bj, bt) = both(*ratio_inputs(m, m, unbounded))
    flag_j, flag_t = jnp.asarray(bland), torch.tensor(bland)
    pairs = [
        (xk.ratio_argmin(xj, aj, bj, 1e-7, flag_j),
         ops.ratio_argmin(xt, at, bt, 1e-7, flag_t)),
        (xk.ratio_argmin_harris(xj, aj, bj, 1e-7, flag_j, 1e-6),
         ops.ratio_argmin_harris(xt, at, bt, 1e-7, flag_t, 1e-6)),
    ]
    for (q_j, t_j, u_j), (q_t, t_t, u_t) in pairs:
        assert int(q_t) == int(q_j)
        assert bool(u_t) == bool(u_j) == unbounded
        np.testing.assert_allclose(float(t_t), float(t_j), rtol=1e-6)


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("bland", [False, True])
def test_ratio_eta_plain_matches_pallas(m, harris, bland, monkeypatch, no_library):
    monkeypatch.setenv("SIMPLEX_TPU_FUSED", "1")
    for unbounded in (False, True):
        (xj, xt), (aj, at), (bj, bt) = both(*ratio_inputs(m, 2 * m, unbounded))
        want = pk.ratio_eta(xj, aj, bj, 1e-7, jnp.asarray(bland), harris, 1e-6)
        assert want is not None
        for fn in (hopper.ratio_eta_plain, hopper.ratio_eta):
            got = fn(xt, at, bt, 1e-7, torch.tensor(bland), harris, 1e-6)
            assert int(got[0]) == int(want[0])
            assert bool(got[2]) == bool(want[2]) == unbounded
            np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
            np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6)
            np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-6)


def test_ratio_eta_int32_flag_and_odd_shape(no_library):
    x_b, alpha, basis = ratio_inputs(37, 11)
    (xj, xt), (aj, at), (bj, bt) = both(x_b, alpha, basis)
    q_j, t_j, _ = xk.ratio_argmin_harris(xj, aj, bj, 1e-7, jnp.asarray(True), 1e-6)
    q, t, unb, eta, x_new = hopper.ratio_eta(
        xt, at, bt, 1e-7, torch.tensor([1], dtype=torch.int32), True
    )
    assert int(q) == int(q_j) and not bool(unb)
    np.testing.assert_allclose(float(t), float(t_j), rtol=1e-6)
    # eta / x_b_new against the JAX step's own expressions (step.py:803, 852-857)
    a_q = alpha[int(q)]
    want_eta = -alpha / a_q
    want_eta[int(q)] = 1 / a_q - 1
    want_x = x_b - float(t) * alpha
    want_x[int(q)] = float(t)
    np.testing.assert_allclose(eta.numpy(), want_eta, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_new.numpy(), want_x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [128, 512])
def test_rank1_update_plain_matches_pallas(m, no_library):
    B, eta, row = rand((m, m), 11), rand((m,), 12), rand((m,), 13)
    (Bj, Bt), (ej, et), (rj, rt) = both(B, eta, row)
    want = np.asarray(pk.rank1_update(Bj, ej, rj))
    for fn in (hopper.rank1_update_plain, hopper.rank1_update):
        Bc = Bt.clone()
        out = fn(Bc, et, rt)
        assert out.data_ptr() == Bc.data_ptr()  # in place
        np.testing.assert_allclose(Bc.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rank1_update_odd_shape_matches_xla(no_library):
    m = 7
    B, eta, row = rand((m, m), 14), rand((m,), 15), rand((m,), 16)
    want = np.asarray(xk.rank1_update(*(jnp.asarray(a) for a in (B, eta, row))))
    Bt = torch.from_numpy(B.copy())
    hopper.rank1_update(Bt, torch.from_numpy(eta), torch.from_numpy(row))
    np.testing.assert_allclose(Bt.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_unsupported_input(no_library):
    A = torch.zeros(4, 8)
    y, c = torch.zeros(4), torch.zeros(8)
    with pytest.raises(ValueError):
        hopper.pricing_scan(y, A.double(), c, 1e-6)  # dtype
    with pytest.raises(ValueError):
        hopper.pricing_scan(torch.zeros(5), A, c, 1e-6)  # shape
    with pytest.raises(ValueError):
        hopper.pricing_scan(y, torch.zeros(8, 4).T, c, 1e-6)  # not contiguous
    x, a, b = torch.zeros(4), torch.ones(4), torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        hopper.ratio_eta(x, a, b.long(), 1e-7, torch.tensor(False), True)
    with pytest.raises(ValueError):
        hopper.ratio_eta(x, a, b, 1e-7, torch.tensor([0.0]), True)
    B = torch.eye(4)
    with pytest.raises(ValueError):
        hopper.rank1_update(B, torch.ones(4), B[2])  # row aliases B_inv
    with pytest.raises(ValueError):
        hopper.rank1_update(B.double(), torch.ones(4), torch.ones(4).double())  # mixed dtypes


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("unbounded", [False, True])
def test_ratio_argmin_matches_pallas(m, bland, unbounded, no_library):
    (xj, xt), (aj, at), (bj, bt) = both(*ratio_inputs(m, 3 * m, unbounded))
    q_j, t_j, u_j = pk.ratio_argmin(xj, aj, bj, 1e-7, jnp.asarray(bland))
    for fn in (hopper.ratio_argmin_plain, hopper.ratio_argmin):
        q_t, t_t, u_t = fn(xt, at, bt, 1e-7, torch.tensor(bland))
        assert q_t.dtype == torch.int32 and int(q_t) == int(q_j)
        assert bool(u_t) == bool(u_j) == unbounded
        assert float(t_t) == float(t_j)  # one IEEE division each: bitwise


@pytest.mark.parametrize("m", [1, 7, 300, 1001])
def test_ratio_argmin_odd_m_matches_xla(m, no_library):
    (xj, xt), (aj, at), (bj, bt) = both(*ratio_inputs(m, 5 * m))
    for bland in (False, True):
        q_j, t_j, u_j = xk.ratio_argmin(xj, aj, bj, 1e-7, jnp.asarray(bland))
        q_t, t_t, u_t = hopper.ratio_argmin(
            xt, at, bt, 1e-7, torch.tensor([int(bland)], dtype=torch.int32)
        )
        assert int(q_t) == int(q_j) and bool(u_t) == bool(u_j)
        assert float(t_t) == float(t_j)


def test_ratio_argmin_backends_and_rejects(no_library):
    from simplex_tpu_torch.kernels.dispatch import get_backend

    assert get_backend("hopper").ratio_argmin is hopper.ratio_argmin
    assert get_backend("torch").ratio_argmin is ops.ratio_argmin
    for name in ("hopper", "torch"):
        assert get_backend(name).ratio_argmin_harris is ops.ratio_argmin_harris
    x, a, b = torch.zeros(4), torch.ones(4), torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        hopper.ratio_argmin(x, a.double(), b, 1e-7, torch.tensor(False))
    with pytest.raises(ValueError):
        hopper.ratio_argmin(x, a, b[:3], 1e-7, torch.tensor(False))
    with pytest.raises(ValueError):
        hopper.ratio_argmin(x, a, b, 1e-7, torch.tensor([False, True]))
    with pytest.raises(ValueError):
        hopper.ratio_argmin(torch.zeros(0), torch.zeros(0), b[:0], 1e-7, torch.tensor(False))
    with pytest.raises(ValueError):
        hopper.ratio_argmin(x, a, b, 1e-7, torch.tensor(0.0))  # a float flag
    # CPU tensors take the plain version: no build, no launch, the flag as
    # a bool or an int32
    hopper.reset_launches()
    for flag in (torch.tensor(True), torch.tensor([1], dtype=torch.int32)):
        q, theta, unb = hopper.ratio_argmin(x, a, b, 1e-7, flag)
        assert (int(q), float(theta), bool(unb)) == (0, 0.0, False)
    assert hopper.launches["ratio_argmin"] == 0


@pytest.mark.parametrize("m,blocks", [(1, 1), (1024, 1), (1025, 2), (8192, 8), (9000, 8)])
def test_ratio_argmin_cluster_follows_m(m, blocks):
    # one row a thread: a block of 1024 rows each up to 8 blocks, then a
    # stride loop; the same choice as ratio_eta's kernel
    assert hopper._ratio_cluster(m) == blocks
    assert blocks * hopper._RATIO_BLOCK_ROWS >= min(m, 8 * hopper._RATIO_BLOCK_ROWS)


def bf16_pair(shape, seed):
    """One bf16 matrix in both packages, from the same rounded values."""
    a = torch.from_numpy(rand(shape, seed)).to(torch.bfloat16)
    return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16), a


@pytest.mark.parametrize(
    "m,n,segments,s", [(16, 512, 4, 1), (32, 1024, 8, 5), (128, 1024, 4, 3)]
)
def test_pricing_scan_bf16_segment_view_matches_pallas(m, n, segments, s, no_library):
    # a column segment of the bf16 shadow, priced as a strided view (no
    # copy), against the Pallas kernel on the same segment
    y, c = rand((m,), 20), rand((n,), 21)
    Aj, At = bf16_pair((m, n), 22)
    w = n // segments
    view = At[:, s * w : (s + 1) * w]
    assert view.stride() == (n, 1) and not view.is_contiguous()
    eps = 1e-6
    lo, hi = s * w, (s + 1) * w
    want = pk.pricing_scan(jnp.asarray(y), Aj[:, lo:hi], jnp.asarray(c[lo:hi]), eps)
    ct = torch.from_numpy(c)[lo:hi]
    for fn in (hopper.pricing_scan_plain, hopper.pricing_scan):
        got = fn(torch.from_numpy(y), view, ct, eps)
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


def test_pricing_scan_rejects_bad_strides(no_library):
    y, c = torch.zeros(4), torch.zeros(4)
    A = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        hopper.pricing_scan(y, A[:, ::4], c, 1e-6)  # column stride 4
    with pytest.raises(ValueError):
        hopper.pricing_scan(y, A.T[:4], c, 1e-6)  # transposed: column stride 16
    hopper.pricing_scan(y, A[:, 4:8], c, 1e-6)  # a column range: fine


def test_gather_columns_and_top_k_match_jax():
    import jax

    m, n, K = 6, 40, 5
    A = rand((m, n), 23)
    x = rand((n,), 24)  # tie-free
    idx = np.array([3, 39, 0, 17, 17], np.int32)
    (Aj, At), (ij, it) = both(A, idx)
    np.testing.assert_array_equal(
        ops.gather_columns(At, it).numpy(), np.asarray(xk.gather_columns(Aj, ij))
    )
    v_j, i_j = jax.lax.approx_max_k(jnp.asarray(x), K)
    v_t, i_t = ops.top_k(torch.from_numpy(x), K)
    assert i_t.dtype == torch.int32
    assert set(i_t.tolist()) == set(np.asarray(i_j).tolist())
    np.testing.assert_array_equal(np.sort(v_t.numpy()), np.sort(np.asarray(v_j)))


def test_shared_header_is_part_of_the_build_name(tmp_path, monkeypatch):
    # both ratio sources include csrc/ratio_cluster.cuh: an edited header
    # must give the library another name, so every object is rebuilt
    import shutil

    from simplex_tpu_torch.kernels import _build

    assert _build.HEADERS == ("ratio_cluster.cuh",)
    for src in ("ratio_argmin.cu", "ratio_eta.cu"):
        text = (_build.CSRC / src).read_text()
        assert '#include "ratio_cluster.cuh"' in text
        assert "cluster_reduce(" in text and "T cluster_reduce" not in text
    assert (_build.CSRC / "ratio_cluster.cuh").read_text().count("T cluster_reduce(") == 1
    before = _build.library_path().name
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path().name == before
    with open(copy / "ratio_cluster.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path().name != before
