"""The float64 stream layout of ``pricing_scan`` (``csrc/pricing_scan.cu``):
its host-side plan, the layout each call takes, the row chunks that fix
pricing's sum order, and the plain versions that CPU tensors run, on the
CPU.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds
the new layout bit for bit against the old one and against the plain
version. Here: every work item of a plan is visited once (the plan's
numbers are the ones the kernel takes, walked by the kernel's loop as
``_pricing_items`` writes it out), the layout is a function of dtypes,
shape and alignment alone, ``_pricing_chunks`` keeps its values (a change
would move every float64 pricing sum), and a CPU call with either layout
named gives the plain version's result and JAX's
(``simplex_tpu.kernels.xla``) without touching the CUDA library; so does
the float64 rank-1 update.

Tolerances: indices exactly, the plain versions bit for bit; reduced-cost
minima rtol 1e-12 against JAX (float64 sums in another order); the rank-1
update within 1e-15 of JAX (XLA and the CPU's BLAS ger may fuse the
multiply-add; on the card the kernel is held bit for bit against the
unfused B + outer(eta, row)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.kernels import xla as xk
from simplex_tpu_torch.kernels import _build, hopper

F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16


@pytest.fixture
def no_library(monkeypatch):
    """Fail any attempt to build or load the CUDA library."""

    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    hopper.reset_launches()
    yield
    assert not any(hopper.launches.values()), hopper.launches


# (m, n) -> (rows a chunk, chunks): the bench's 8192 x 16384, its column
# segment (8 segments), odd shapes, the bounded route's A and B, the
# general route's C, a single chunk, the four-card class
PRICING_CHUNKS = {
    (8192, 16384): (125, 66),
    (8192, 16380): (125, 66),
    (8192, 2048): (32, 256),
    (8191, 16383): (125, 66),
    (9000, 1001): (32, 282),
    (9000, 1004): (32, 282),
    (24, 4099): (32, 1),
    (1088, 4160): (32, 34),
    (4352, 16640): (70, 63),
    (1088, 67648): (68, 16),
    (32768, 131072): (3641, 9),
}


@pytest.mark.parametrize("shape", sorted(PRICING_CHUNKS))
def test_pricing_chunks_pinned(shape):
    assert hopper._pricing_chunks(*shape) == PRICING_CHUNKS[shape]


# (m, n, chunk_n): the bench, a segment view (its own width's chunks), a
# column shard of 2 and 4 ranks (the whole matrix's chunks), odd shapes
PLANS = [
    (8192, 16384, None), (8192, 2048, None), (8192, 8192, 16384), (8192, 4096, 16384),
    (9000, 1004, None), (4352, 16640, None), (1088, 67648, None), (300, 256, None),
    (2048, 4096, None), (8192, 4, None), (8192, 16380, None),
]


def _pricing_items(plan, cta):
    """The (column tile, row chunk) items CTA ``cta`` walks, in order: the
    loop of ``pricing_stream_kernel`` (``csrc/pricing_scan.cu``) over
    w = cta, cta + grid, ... below col_tiles x chunks."""
    items = plan["col_tiles"] * plan["chunks"]
    return [divmod(w, plan["col_tiles"])[::-1] for w in range(cta, items, plan["grid"])]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("m,n,chunk_n", PLANS)
def test_pricing_stream_plan_visits_every_item_once(m, n, chunk_n, sms):
    plan = hopper.pricing_stream_plan(m, n, chunk_n, sms)
    rows, chunks = hopper._pricing_chunks(m, n if chunk_n is None else chunk_n)
    assert (plan["rows"], plan["chunks"]) == (rows, chunks)
    assert plan["col_tiles"] == -(-n // hopper._PRICING_STREAM_COLS)
    assert 0 < plan["grid"] <= plan["col_tiles"] * chunks
    assert plan["grid"] <= sms * hopper._PRICING_STREAM_CTAS
    seen = []
    for cta in range(plan["grid"]):
        items = _pricing_items(plan, cta)
        assert items, f"CTA {cta} has no item"
        # chunk by chunk: a CTA's items never go back to an earlier chunk
        assert [ch for _, ch in items] == sorted(ch for _, ch in items)
        seen += items
    assert sorted(seen) == [(t, ch) for t in range(plan["col_tiles"]) for ch in range(chunks)]
    # the row chunks cover [0, m) once
    spans = [(ch * rows, min(m, (ch + 1) * rows)) for ch in range(chunks)]
    assert spans[0][0] == 0 and spans[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("a_dtype,dtype,m,n,lda,aligned,chunk_n,want", [
    (F64, F64, 8192, 16384, 16384, True, None, "stream"),  # the bench's pass
    (F64, F64, 8192, 2048, 16384, True, None, "stream"),  # an aligned segment view
    (F64, F64, 8192, 2048, 16384, False, None, "split"),  # a view one column off
    (F64, F64, 8192, 4096, 4096, True, 16384, "stream"),  # a shard, the whole width's chunks
    (F64, F64, 4352, 16640, 16640, True, None, "stream"),  # the bounded route's B
    (F64, F64, 1088, 67648, 67648, True, None, "stream"),  # the general route's C: a part-filled last tile
    (F64, F64, 8192, 16380, 16380, True, None, "stream"),  # n % 256 = 252
    (F64, F64, 8191, 16383, 16383, True, None, "split"),  # n % 4
    (F64, F64, 9000, 1001, 1001, True, None, "split"),
    (F64, F64, 9000, 1004, 1006, True, None, "split"),  # lda % 4
    (F64, F64, 24, 4099, 4099, True, None, "split"),
    (F64, F64, 24, 4096, 4096, True, None, "split"),  # one row chunk: one launch already
    (F32, F32, 8192, 16384, 16384, True, None, "split"),  # float32 keeps the two-launch layout
    (BF16, F32, 8192, 16384, 16384, True, None, "split"),
    (BF16, F64, 8192, 16384, 16384, True, None, "split"),  # the shadow with float64 vectors
])
def test_pricing_layout(a_dtype, dtype, m, n, lda, aligned, chunk_n, want):
    assert hopper.pricing_layout(a_dtype, dtype, m, n, lda, aligned, chunk_n) == want


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("layout", [None, "split", "stream"])
def test_cpu_pricing_runs_the_plain_version(layout, no_library):
    m, n = 40, 300
    y, A, c = _rand(m, 1), _rand((m, n), 2), _rand(n, 3)
    basis = np.random.default_rng(4).permutation(n)[:m].astype(np.int32)
    t = [torch.from_numpy(v) for v in (y, A, c)]
    bt = torch.from_numpy(basis)
    for bland in (False, True):
        flag = torch.tensor(bland)
        got = hopper._pricing_call(*t, 1e-9, None, bt, 0, flag, 0, None, layout)
        want = hopper.pricing_scan_plain(*t, 1e-9, None, bt)
        for g, w in zip(got[:3], want):
            assert torch.equal(g, w)
        p_j, min_j = xk.choose_entering(
            jnp.asarray(y), jnp.asarray(A), xk.mask_basic(jnp.asarray(c), jnp.asarray(basis)), 1e-9,
            jnp.asarray(bland))
        assert int(got[3]) == int(p_j)
        np.testing.assert_allclose(float(got[0]), float(min_j), rtol=1e-12)


def test_cpu_rank1_runs_the_plain_version(no_library):
    m = 24
    B, eta, row = _rand((m, m), 5), _rand(m, 6), _rand(m, 7)
    Bt = torch.from_numpy(B.copy())
    out = hopper.rank1_update(Bt, torch.from_numpy(eta), torch.from_numpy(row))
    assert out.data_ptr() == Bt.data_ptr()  # in place
    plain = hopper.rank1_update_plain(torch.from_numpy(B.copy()), torch.from_numpy(eta), torch.from_numpy(row))
    assert torch.equal(Bt, plain)
    want = np.asarray(xk.rank1_update(*(jnp.asarray(v) for v in (B, eta, row))))
    np.testing.assert_allclose(Bt.numpy(), want, rtol=1e-15, atol=1e-15)


def test_unknown_layouts_raise(no_library):
    y, A, c = torch.zeros(4, dtype=F64), torch.zeros(4, 8, dtype=F64), torch.zeros(8, dtype=F64)
    with pytest.raises(ValueError, match="layout"):
        hopper._pricing_call(y, A, c, 1e-9, None, None, 0, None, 0, None, "tiles")


def test_layout_bench_times_both_layouts_on_cpu(no_library):
    # the per-op bench's float64 layout line: both layouts of pricing and
    # the library call beside them (plain versions on CPU tensors)
    from simplex_tpu_torch.bench import kernels as bk

    rec = bk.layout_ops(16, 64, k=1, device="cpu")
    assert list(rec) == ["pricing stream", "pricing split", "torch.mv(A.T, y)"]
    assert all(r["ms"] >= 0 and len(r["ms_runs"]) == 2 for r in rec.values())


def test_profile_canonical_runs_in_float64_on_cpu(tmp_path, capsys, no_library):
    import json

    from simplex_tpu_torch.bench import profile_canonical as pc

    out = tmp_path / "p.json"
    assert pc.main(["--device", "cpu", "--only", "default", "--dtype", "float64", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert list(rec) == ["default"] and rec["default"]["pivots_traced"] > 0
