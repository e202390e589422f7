"""The sum-order probe's inputs, comparison and report on the CPU, and the
SASS counter that reads its verdict's consequence (DMMA instructions). The
probe kernel itself runs on the card only
(``python -m simplex_tpu_torch.bench.dmma_probe``; ``chip_smoke.py``)."""

from __future__ import annotations

import collections

import pytest
import torch

from simplex_tpu_torch.bench import dmma_probe, sass_ops

F64 = torch.float64


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("lo, hi", [(-1074, -1023), (-1022, 1023), (-500, 500)])
def test_pow2_is_exact(lo, hi):
    """2^k from its bits: a mantissa of exactly 1/2 and k in [lo, hi],
    subnormal powers included."""
    x = dmma_probe._pow2((4096,), lo, hi, _g())
    mant, e = torch.frexp(x)
    assert x.dtype == F64
    assert bool((mant == 0.5).all())
    k = e - 1
    assert int(k.min()) >= lo and int(k.max()) <= hi
    assert int(k.min()) < lo + (hi - lo) // 4 and int(k.max()) > hi - (hi - lo) // 4


@pytest.mark.parametrize("shape", dmma_probe.SHAPES, ids=[s[0] for s in dmma_probe.SHAPES])
@pytest.mark.parametrize("kind", ("random",) + dmma_probe.ADVERSARIAL)
def test_tiles(kind, shape):
    """Every kind of tile for every shape: (T, M, K), (T, K, 8), (T, M, 8)
    contiguous doubles, with the property that names the kind."""
    _, M, K = shape
    a, b, c = dmma_probe.tiles(kind, 64, M, K, _g(3))
    assert (a.shape, b.shape, c.shape) == ((64, M, K), (64, K, 8), (64, M, 8))
    assert all(t.dtype == F64 and t.is_contiguous() for t in (a, b, c))
    prod = torch.bmm(a, b)
    if kind == "cancel":  # C undoes the products up to the noise
        assert float((prod + c).abs().max()) < 2.0 ** -30
    elif kind == "exponents":
        assert float(a.abs().max()) > 2.0 ** 300 and float(a.abs().min()) < 2.0 ** -300
    elif kind == "subnormal":
        assert bool((c.abs() < 2.0 ** -1022).all())
        small = (a[:, :, :, None] * b[:, None, :, :]).abs() < 2.0 ** -1022
        assert float(small.double().mean()) > 0.5
    elif kind == "overflow":
        assert float(c.abs().max()) > 2.0 ** 1000 and bool(prod.isinf().any() | (prod.abs() > 2.0 ** 1015).any())
    elif kind == "zeros":
        assert bool((c == 0).all()) and bool(c.signbit().any()) and bool((~c.signbit()).any())
        z = a == 0
        assert bool(z.any()) and bool(a[z].signbit().any()) and bool((~a[z].signbit()).any())
    elif kind == "inf_nan":
        for t in (a, b, c):
            assert bool((t == float("inf")).any()) and bool((t == float("-inf")).any()) and bool(t.isnan().any())
    elif kind == "absorb":
        assert float(c.abs().max() / c.abs().min()) > 2.0 ** 60
    else:
        assert bool(prod.isfinite().all())


def test_differ_is_bitwise_but_nan_equals_nan():
    nan2 = torch.tensor([0x7FF8000000000001], dtype=torch.int64).view(F64)
    d = torch.tensor([float("nan"), -0.0, 1.0, 2.0], dtype=F64)
    r = torch.cat([nan2, torch.tensor([0.0, 1.0, 2.0], dtype=F64)])
    r[3] = torch.nextafter(r[3], torch.tensor(3.0, dtype=F64))
    assert dmma_probe._differ(d, r).tolist() == [False, True, False, True]


def test_verdict_lines():
    res = {
        "m8n8k4": {"compiled": True, "tiles": 8, "outputs": 512, "equals_ascending_chain": True,
                   "differ_ascending": {"random": 0}, "differ_descending": {"random": 7},
                   "max_rel_err_random": 0.0},
        "m16n8k4": {"compiled": True, "tiles": 8, "outputs": 1024, "equals_ascending_chain": False,
                    "differ_ascending": {"random": 2}, "differ_descending": {"random": 0},
                    "max_rel_err_random": 1e-16},
        "m16n8k16": {"compiled": False},
    }
    lines = dmma_probe.verdict_lines(res)
    assert "EQUALS the ascending fma chain" in lines[0] and "7 differ" in lines[0]
    assert "DIFFERS FROM the ascending fma chain" in lines[1] and "(2 differ" in lines[1]
    assert "not in this build" in lines[2]


def test_probe_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dmma_probe.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("op, want", [("DMMA", 5), ("IMAD.X", 4), ("IMAD", 5), ("DFMA", 0)])
def test_sass_ops_count(op, want):
    """An opcode with a modifier counts itself; one without counts every
    modifier of it."""
    c = collections.Counter({"DMMA.884": 3, "DMMA.16816": 2, "IMAD.X": 4, "IMAD": 1, "DFMAX": 9})
    assert sass_ops.count(c, op) == want
