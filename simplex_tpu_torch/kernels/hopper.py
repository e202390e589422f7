"""Hand-written Hopper (sm_90a) kernels for the pivot step's hot ops.

Each wrapper stands beside its plain PyTorch version and a launch counter:

  =================  ==========================  =============================
  wrapper            CUDA source                 replaces (Pallas)
  =================  ==========================  =============================
  pricing_scan       csrc/pricing_scan.cu        pallas_ops.pricing_scan;
                                                 signed: the bounded rule's
                                                 pricing (XLA in JAX)
  ratio_argmin       csrc/ratio_argmin.cu        pallas_ops.ratio_argmin
  ratio_eta          csrc/ratio_eta.cu           pallas_ops.ratio_eta
  rank1_update       csrc/rank1_update.cu        pallas_ops.rank1_update
  =================  ==========================  =============================

A wrapper checks its inputs and raises on anything its kernel does not take.
Given CPU tensors it returns the plain version's result (that is how the CPU
tests run the hopper backend); given CUDA tensors it launches the kernel on
the current stream or raises: there is no fallback. ``launches[name]`` counts
kernel launches only, so a run can show that its main path went through the
kernels. The library is built at the first launch
(:mod:`simplex_tpu_torch.kernels._build`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simplex_tpu_torch.kernels import _build
from simplex_tpu_torch.kernels import ops as _ops

INT_MAX = _ops.INT_MAX

# kernel launches per wrapper since the last reset_launches()
launches = {
    "pricing_scan": 0, "ratio_argmin": 0, "ratio_eta": 0, "rank1_update": 0,
}

# pricing pass 1 splits the rows into chunks so that about this many blocks
# of 1024 columns are in flight (8 per SM on a 132-SM H100)
_PRICING_TARGET_BLOCKS = 1056
_PRICING_COLS_PER_BLOCK = 1024
_PRICING_MIN_ROWS = 32
_PRICING_REDUCE_THREADS = 256


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    _require(all(t.device == dev for t in ts), "inputs on different devices")
    _require(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev


def _vector(t: torch.Tensor, n: int, dtype: torch.dtype, name: str) -> None:
    _require(t.shape == (n,), f"{name}: shape {tuple(t.shape)} != ({n},)")
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype} != {dtype}")
    _require(t.is_contiguous(), f"{name}: not contiguous")


def _flag(t: torch.Tensor, name: str) -> None:
    _require(t.numel() == 1, f"{name}: want one element, got {tuple(t.shape)}")
    _require(t.dtype in (torch.bool, torch.int32), f"{name}: dtype {t.dtype}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


# --------------------------------------------------------------------------
# pricing scan
# --------------------------------------------------------------------------


def pricing_scan_plain(
    y: torch.Tensor, A: torch.Tensor, c: torch.Tensor, eps: float,
    at_upper: Optional[torch.Tensor] = None, basis: Optional[torch.Tensor] = None,
    base_col: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(min_e, argmin_e, first j with e_j < -eps or INT_MAX)`` for
    e = y.A - c (lowest index on ties); in the signed mode for s =
    (at_upper ? -e : e) plus BASIC_PENALTY at the basic columns instead."""
    e = _ops.reduced_costs(y, A, c)
    if at_upper is not None:
        e = _ops.add_basic_penalty(torch.where(at_upper, -e, e), basis, base_col)
    idx = torch.arange(e.shape[0], device=e.device, dtype=torch.int32)
    p_neg = torch.where(e < -eps, idx, INT_MAX).min()
    return e.min(), torch.argmin(e).to(torch.int32), p_neg


def _pricing_chunks(m: int, n: int) -> Tuple[int, int]:
    """``(rows_per_chunk, chunks)`` of pricing pass 1: a function of the
    shape alone, so the summation order (and the result) is fixed."""
    col_tiles = -(-n // _PRICING_COLS_PER_BLOCK)
    want = max(1, -(-_PRICING_TARGET_BLOCKS // col_tiles))
    rows = max(_PRICING_MIN_ROWS, -(-m // want))
    return rows, -(-m // rows)


def pricing_scan(
    y: torch.Tensor, A: torch.Tensor, c: torch.Tensor, eps: float,
    at_upper: Optional[torch.Tensor] = None, basis: Optional[torch.Tensor] = None,
    base_col: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over A: ``(min_e, argmin_e, first index with e < -eps or
    INT_MAX)`` as 0-d device tensors, e = y.A - c never stored.

    A is (m, n) float32 or bfloat16 (upcast per element) with unit column
    stride: a contiguous matrix or a column range of one
    (``A_price[:, s*w:(s+1)*w]``), scanned in place. y (m,) and c (n,)
    float32 contiguous; all on one device. Signed mode (the bounded rule):
    given ``at_upper`` (n,) bool and ``basis`` (m,) int32, both contiguous,
    the scan runs over s = (at_upper ? -e : e) + BASIC_PENALTY at the basic
    columns, A being columns [base_col, base_col + n) of the problem's.
    """
    _require(A.dim() == 2, f"A: want a matrix, got {tuple(A.shape)}")
    m, n = A.shape
    _require(m > 0 and n > 0, f"A: empty shape {tuple(A.shape)}")
    _require(A.dtype in (torch.float32, torch.bfloat16), f"A: dtype {A.dtype}")
    lda = A.stride(0)
    _require(
        A.stride(1) == 1 and (m == 1 or lda >= n),
        f"A: want unit column stride and rows at least n apart, got strides {A.stride()}",
    )
    _vector(y, m, torch.float32, "y")
    _vector(c, n, torch.float32, "c")
    ins = (y, A, c)
    _require((at_upper is None) == (basis is None), "at_upper and basis go together")
    if at_upper is not None:
        _vector(at_upper, n, torch.bool, "at_upper")
        _vector(basis, m, torch.int32, "basis")
        ins += (at_upper, basis)
    dev = _same_device(*ins)
    if dev.type == "cpu":
        return pricing_scan_plain(y, A, c, eps, at_upper, basis, base_col)
    lib = _build.load_library()
    rows, chunks = _pricing_chunks(m, n)
    nblk = -(-n // _PRICING_REDUCE_THREADS)
    partial = torch.empty((chunks, n), dtype=torch.float32, device=dev)
    blk_min = torch.empty(nblk, dtype=torch.float32, device=dev)
    blk_idx = torch.empty((2, nblk), dtype=torch.int32, device=dev)
    out_min = torch.empty((), dtype=torch.float32, device=dev)
    out_idx = torch.empty(2, dtype=torch.int32, device=dev)
    pen = None if at_upper is None else torch.empty(n, dtype=torch.float32, device=dev)
    align = 16 if A.dtype == torch.float32 else 8
    vec = n % 4 == 0 and lda % 4 == 0 and A.data_ptr() % align == 0
    err = lib.simplex_pricing_scan(
        0 if A.dtype == torch.float32 else 1,
        y.data_ptr(), A.data_ptr(), c.data_ptr(),
        None if at_upper is None else at_upper.data_ptr(),
        None if basis is None else basis.data_ptr(), m, int(base_col),
        None if pen is None else pen.data_ptr(), m, n, lda, eps, rows, chunks,
        int(vec), partial.data_ptr(), blk_min.data_ptr(),
        blk_idx[0].data_ptr(), blk_idx[1].data_ptr(), out_min.data_ptr(),
        out_idx[0].data_ptr(), out_idx[1].data_ptr(), _stream(dev),
    )
    _build.check(err, "pricing_scan")
    launches["pricing_scan"] += 1
    return out_min, out_idx[0], out_idx[1]


def choose_entering(y, A, c, eps, use_bland) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`simplex_tpu_torch.kernels.ops.choose_entering`,
    through :func:`pricing_scan`."""
    min_e, p_dantzig, p_neg = pricing_scan(y, A, c, eps)
    p_bland = torch.where(p_neg == INT_MAX, 0, p_neg)
    return torch.where(use_bland, p_bland, p_dantzig), min_e


def choose_entering_bounded(
    y, A, c, at_upper, basis, base_col, eps, use_bland
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as
    :func:`simplex_tpu_torch.kernels.ops.choose_entering_bounded`, through
    :func:`pricing_scan`'s signed mode: one pass over A (fp32, the bf16
    shadow or a segment view of either), no fp32 copy of a bf16 A, and the
    basic-column penalty made inside the same call."""
    min_s, p_dantzig, p_neg = pricing_scan(y, A, c, eps, at_upper, basis, base_col)
    p_bland = torch.where(p_neg == INT_MAX, 0, p_neg)
    return torch.where(use_bland, p_bland, p_dantzig), min_s


# --------------------------------------------------------------------------
# classic masked ratio test
# --------------------------------------------------------------------------


def ratio_argmin_plain(x_b, alpha, basis, pivot_tol, use_bland):
    """The classic ratio test
    (:func:`simplex_tpu_torch.kernels.ops.ratio_argmin`)."""
    return _ops.ratio_argmin(
        x_b, alpha, basis, pivot_tol, use_bland.to(torch.bool).view(())
    )


def ratio_argmin(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, theta_q, unbounded)`` of the classic masked ratio test in one
    launch, every result a 0-d device tensor. x_b, alpha (m,) float32;
    basis (m,) int32; use_bland a one-element bool or int32 tensor. Any m."""
    m = x_b.shape[0] if x_b.dim() == 1 else -1
    _require(m > 0, f"x_b: want a non-empty vector, got {tuple(x_b.shape)}")
    _vector(x_b, m, torch.float32, "x_b")
    _vector(alpha, m, torch.float32, "alpha")
    _vector(basis, m, torch.int32, "basis")
    _flag(use_bland, "use_bland")
    dev = _same_device(x_b, alpha, basis, use_bland)
    if dev.type == "cpu":
        return ratio_argmin_plain(x_b, alpha, basis, pivot_tol, use_bland)
    lib = _build.load_library()
    bland = use_bland.to(torch.int32).reshape(1)
    q = torch.empty((), dtype=torch.int32, device=dev)
    theta_q = torch.empty((), dtype=torch.float32, device=dev)
    unbounded = torch.empty((), dtype=torch.bool, device=dev)
    err = lib.simplex_ratio_argmin(
        x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(), bland.data_ptr(),
        m, pivot_tol, q.data_ptr(), theta_q.data_ptr(), unbounded.data_ptr(),
        _stream(dev),
    )
    _build.check(err, "ratio_argmin")
    launches["ratio_argmin"] += 1
    return q, theta_q, unbounded


# --------------------------------------------------------------------------
# fused ratio test + eta + x_b step
# --------------------------------------------------------------------------


def ratio_eta_plain(x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol=1e-6):
    """The ratio test composed with the eta / x_b epilogue
    (:func:`simplex_tpu_torch.kernels.ops.ratio_eta`)."""
    return _ops.ratio_eta(
        x_b, alpha, basis, pivot_tol, use_bland.to(torch.bool).view(()),
        harris, feas_tol,
    )


def ratio_eta(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
    harris: bool,
    feas_tol: float = 1e-6,
):
    """``(q, theta_q, unbounded, eta, x_b_new)`` in one launch, every result
    on the device. x_b, alpha (m,) float32; basis (m,) int32; use_bland a
    one-element bool or int32 tensor. eta and x_b_new are computed as if the
    pivot proceeds; the caller discards them on a terminal step."""
    m = x_b.shape[0] if x_b.dim() == 1 else -1
    _require(m > 0, f"x_b: want a non-empty vector, got {tuple(x_b.shape)}")
    _vector(x_b, m, torch.float32, "x_b")
    _vector(alpha, m, torch.float32, "alpha")
    _vector(basis, m, torch.int32, "basis")
    _flag(use_bland, "use_bland")
    dev = _same_device(x_b, alpha, basis, use_bland)
    if dev.type == "cpu":
        return ratio_eta_plain(x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol)
    lib = _build.load_library()
    bland = use_bland.to(torch.int32).reshape(1)
    q = torch.empty((), dtype=torch.int32, device=dev)
    theta_q = torch.empty((), dtype=torch.float32, device=dev)
    unbounded = torch.empty((), dtype=torch.bool, device=dev)
    eta = torch.empty(m, dtype=torch.float32, device=dev)
    x_b_new = torch.empty(m, dtype=torch.float32, device=dev)
    err = lib.simplex_ratio_eta(
        x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(), bland.data_ptr(),
        m, pivot_tol, feas_tol, int(bool(harris)), q.data_ptr(),
        theta_q.data_ptr(), unbounded.data_ptr(), eta.data_ptr(),
        x_b_new.data_ptr(), _stream(dev),
    )
    _build.check(err, "ratio_eta")
    launches["ratio_eta"] += 1
    return q, theta_q, unbounded, eta, x_b_new


# --------------------------------------------------------------------------
# rank-1 product-form update
# --------------------------------------------------------------------------


def rank1_update_plain(B_inv, eta, binv_q) -> torch.Tensor:
    """``B_inv += eta (x) binv_q`` in place
    (:func:`simplex_tpu_torch.kernels.ops.rank1_update`)."""
    return _ops.rank1_update(B_inv, eta, binv_q)


def rank1_update(
    B_inv: torch.Tensor, eta: torch.Tensor, binv_q: torch.Tensor
) -> torch.Tensor:
    """``B_inv += eta (x) binv_q`` IN PLACE; returns B_inv. B_inv (m, m)
    float32 contiguous; eta, binv_q (m,) float32, neither overlapping B_inv
    (row q of B_inv must be passed as a copy, ``B_inv[q].clone()``)."""
    _require(
        B_inv.dim() == 2 and B_inv.shape[0] == B_inv.shape[1] and B_inv.shape[0] > 0,
        f"B_inv: want a non-empty square matrix, got {tuple(B_inv.shape)}",
    )
    m = B_inv.shape[0]
    _require(B_inv.dtype == torch.float32, f"B_inv: dtype {B_inv.dtype}")
    _require(B_inv.is_contiguous(), "B_inv: not contiguous")
    _vector(eta, m, torch.float32, "eta")
    _vector(binv_q, m, torch.float32, "binv_q")
    dev = _same_device(B_inv, eta, binv_q)
    _require(
        not _overlaps(binv_q, B_inv) and not _overlaps(eta, B_inv),
        "rank1_update: eta / binv_q overlap B_inv (pass a copy of the row)",
    )
    if dev.type == "cpu":
        return rank1_update_plain(B_inv, eta, binv_q)
    lib = _build.load_library()
    vec = m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (B_inv, binv_q))
    err = lib.simplex_rank1_update(
        B_inv.data_ptr(), eta.data_ptr(), binv_q.data_ptr(), m, int(vec),
        _stream(dev),
    )
    _build.check(err, "rank1_update")
    launches["rank1_update"] += 1
    return B_inv

