"""The FP64 tensor cores' sum order against the ascending fma chain, on the
card: ``csrc/dmma_probe.cu`` runs every f64 shape of ``mma.sync`` that the
build holds (m8n8k4; m16n8k4, m16n8k8, m16n8k16 where nvcc takes them) on
2^20 random tiles and on adversarial ones (products that cancel C,
exponents 2^+-500, subnormal products, overflowing sums, +-0 accumulators,
inf and NaN), and compares each output with the chain
``acc = fma(a_k, b_k, acc)`` from C in ascending k, and in descending k.
A shape whose every output equals the ascending chain bit for bit (NaN
against NaN) sums as the per-instance pricing's DFMA chain does, so
``csrc/batch_pricing.cu``'s float64 shared-A layouts may use it and stay bit
for bit the per-instance path. One JSON line:

    python -m simplex_tpu_torch.bench.dmma_probe [--tiles 1048576]

``chip_smoke.py`` runs it in its float64 batched kernel phase. Seconds on
one H100.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

SHAPES = (("m8n8k4", 8, 4), ("m16n8k4", 16, 4), ("m16n8k8", 16, 8), ("m16n8k16", 16, 16))
BATCH = 1 << 16  # tiles a launch
ADVERSARIAL = ("cancel", "exponents", "subnormal", "overflow", "zeros", "inf_nan", "absorb")


def _pow2(shape, lo: int, hi: int, g) -> torch.Tensor:
    """2^k elementwise, k uniform in [lo, hi] (lo >= -1074, hi <= 1023),
    built from its bits: exact, subnormal powers included."""
    k = torch.randint(lo, hi + 1, shape, generator=g, device=g.device)
    bits = torch.where(k >= -1022, (k + 1023) << 52, torch.ones_like(k) << (k + 1074).clamp(0, 51))
    return bits.view(torch.float64)


def tiles(kind: str, T: int, M: int, K: int, g) -> tuple:
    """A (T, M, K), B (T, K, 8), C (T, M, 8) doubles of one kind."""
    dev = g.device

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float64)

    a, b, c = rn(T, M, K), rn(T, K, 8), rn(T, M, 8)
    if kind == "cancel":  # C undoes the products: what is left is their rounding
        c = -torch.bmm(a, b) + rn(T, M, 8) * 2.0 ** -40
    elif kind == "exponents":
        a, b, c = a * _pow2(a.shape, -500, 500, g), b * _pow2(b.shape, -500, 500, g), c * _pow2(c.shape, -500, 500, g)
    elif kind == "subnormal":  # products and C below 2^-1022
        a, b = a * 2.0 ** -540, b * _pow2(b.shape, -520, -480, g)
        c = c * _pow2(c.shape, -1070, -1030, g)
    elif kind == "overflow":  # partial sums that overflow in some orders only
        a, b = a * 2.0 ** 510, b * 2.0 ** 510
        c = c * 2.0 ** 1021
    elif kind == "zeros":  # +-0 products and accumulators
        z = torch.rand(a.shape, generator=g, device=dev) < 0.5
        a = torch.where(z, torch.copysign(torch.zeros_like(a), rn(*a.shape)), a)
        z = torch.rand(b.shape, generator=g, device=dev) < 0.5
        b = torch.where(z, torch.copysign(torch.zeros_like(b), rn(*b.shape)), b)
        c = torch.copysign(torch.zeros_like(c), rn(*c.shape))
    elif kind == "inf_nan":
        for t in (a, b, c):
            u = torch.rand(t.shape, generator=g, device=dev)
            t[u < 0.01] = float("inf")
            t[(u >= 0.01) & (u < 0.02)] = float("-inf")
            t[(u >= 0.02) & (u < 0.03)] = float("nan")
    elif kind == "absorb":  # magnitudes 2^+-60 apart: small terms vanish in some orders
        a, b = a * _pow2(a.shape, -30, 30, g), b * _pow2(b.shape, -30, 30, g)
        c = c * _pow2(c.shape, -60, 60, g)
    return a.contiguous(), b.contiguous(), c.contiguous()


def _run(lib, shape: int, a, b, c, descending: bool):
    from simplex_tpu_torch.kernels import _build

    T, M = a.shape[0], a.shape[1]
    d = torch.empty(T, M, 8, dtype=torch.float64, device=a.device)
    r = torch.empty_like(d)
    err = lib.simplex_dmma_probe(shape, a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                                 r.data_ptr(), T, int(descending),
                                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "dmma_probe")
    return d, r


def _differ(d, r) -> torch.Tensor:
    """Outputs not bit for bit equal (any NaN equals any NaN)."""
    same = (d.view(torch.int64) == r.view(torch.int64)) | (d.isnan() & r.isnan())
    return ~same


def probe(dev, n_tiles: int = 1 << 20, seed: int = 0) -> dict:
    """{shape name: verdict} for every shape: ``compiled``; the outputs
    compared; ``differ_ascending`` / ``differ_descending`` by tile kind;
    ``max_rel_err_random`` (the mma against the ascending chain on the
    random tiles: about 1e-16 or 0 when the fragments are laid out as
    assumed); ``equals_ascending_chain``."""
    from simplex_tpu_torch.kernels import _build

    lib = _build.load_library()
    held = lib.simplex_dmma_probe_shapes()
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for code, (name, M, K) in enumerate(SHAPES):
        if not held >> code & 1:
            out[name] = {"compiled": False}
            continue
        kinds = ["random"] * -(-n_tiles // BATCH) + list(ADVERSARIAL)
        rec = {"compiled": True, "outputs": 0, "differ_ascending": {}, "differ_descending": {},
               "max_rel_err_random": 0.0}
        for kind in kinds:
            a, b, c = tiles(kind, BATCH, M, K, g)
            for desc in (False, True):
                d, r = _run(lib, code, a, b, c, desc)
                key = "differ_descending" if desc else "differ_ascending"
                rec[key][kind] = rec[key].get(kind, 0) + int(_differ(d, r).sum())
                if kind == "random" and not desc:
                    rel = ((d - r).abs() / r.abs().clamp_min(1e-300)).max()
                    rec["max_rel_err_random"] = max(rec["max_rel_err_random"], float(rel))
            rec["outputs"] += d.numel()
        rec["tiles"] = len(kinds) * BATCH
        rec["equals_ascending_chain"] = sum(rec["differ_ascending"].values()) == 0
        out[name] = rec
    return out


def verdict_lines(res: dict) -> list:
    lines = []
    for name, r in res.items():
        if not r["compiled"]:
            lines.append(f"dmma probe {name}: not in this build (nvcc took no such shape)")
            continue
        asc, desc = sum(r["differ_ascending"].values()), sum(r["differ_descending"].values())
        lines.append(
            f"dmma probe {name}: {r['tiles']} tiles, {r['outputs']} outputs; "
            f"{'EQUALS' if r['equals_ascending_chain'] else 'DIFFERS FROM'} the ascending fma chain "
            f"bit for bit ({asc} differ: {r['differ_ascending']}); the descending chain: {desc} differ; "
            f"max rel err on random tiles {r['max_rel_err_random']:.3e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m simplex_tpu_torch.bench.dmma_probe")
    ap.add_argument("--tiles", type=int, default=1 << 20, help="random tiles a shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dmma_probe: no CUDA device", file=sys.stderr)
        return 1
    res = probe(torch.device("cuda", 0), args.tiles)
    for line in verdict_lines(res):
        print(line)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
