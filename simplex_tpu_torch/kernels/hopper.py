"""Hand-written Hopper (sm_90a) kernels for the pivot step's hot ops.

Each wrapper stands beside its plain PyTorch version and a launch counter:

  =================  ==========================  =============================
  wrapper            CUDA source                 replaces (Pallas)
  =================  ==========================  =============================
  pricing_scan       csrc/pricing_scan.cu        pallas_ops.pricing_scan;
                                                 signed: the bounded rule's
                                                 pricing (XLA in JAX)
  ratio_argmin       csrc/ratio_argmin.cu        pallas_ops.ratio_argmin
                     (+ ratio_cluster.cuh)
  ratio_eta,         csrc/ratio_eta.cu           pallas_ops.ratio_eta; with
  pivot_tail                                     the tail on, also the O(m)
                                                 selects and scalar updates of
                                                 the step around it
  rank1_update       csrc/rank1_update.cu        pallas_ops.rank1_update
  rank1_update_      csrc/rank1_update.cu        pallas_ops.rank1_update and,
  ftran                                          fused into its pass, the
                                                 next step's ftran product
  choose_entering_   csrc/batch_pricing.cu       pallas_ops.pricing_scan under
  batched                                        vmap (a batch grid axis)
  pivot_tail_        csrc/batch_tail.cu          pallas_ops.ratio_eta under
  batched                                        vmap, with the step's tail
  rank1_update_      csrc/batch_rank1.cu         pallas_ops.rank1_update under
  batched                                        vmap
  =================  ==========================  =============================

A wrapper checks its inputs and raises on anything its kernel does not take.
Every kernel runs in float32 or float64: every float operand of a call in
one of the two (A also the bfloat16 shadow), a mixed call raises. Given CPU
tensors a wrapper
returns the plain version's result (that is how the CPU
tests run the hopper backend); given CUDA tensors it launches the kernel on
the current stream or raises: there is no fallback. ``launches[name]`` counts
kernel launches only, so a run can show that its main path went through the
kernels; while host spans are recorded, each library call is preceded by a
zero-length ``launch:<wrapper>`` mark (:mod:`simplex_tpu_torch.spans`). The
library is built at the first launch
(:mod:`simplex_tpu_torch.kernels._build`).

In float64, ``pricing_scan`` has a second layout, redesigned for the H100
("stream": :func:`pricing_layout`), which its wrapper takes from the
dtypes, shape and alignment alone; the older layout ("split") keeps the
shapes the new one does not take, gives the same bits, and is reachable by
name (``layout=``) only for the tools that hold the two against each other
(``chip_smoke.py``, ``bench/kernels.py``). No option selects a layout, and
a failed launch raises; ``pricing_layouts`` counts the calls each layout
took. Likewise ``rank1_layouts`` counts the rank-1 launches by kind:
``plain`` (:func:`rank1_update`) and ``ftran`` (:func:`rank1_update_ftran`,
whose launches ``launches["rank1_update"]`` counts too).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch import spans
from simplex_tpu_torch.kernels import _build
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus

INT_MAX = _ops.INT_MAX

# kernel launches per wrapper since the last reset_launches()
launches = {
    "pricing_scan": 0, "ratio_argmin": 0, "ratio_eta": 0, "rank1_update": 0,
    "batch_pricing": 0, "batch_tail": 0, "batch_rank1": 0,
}
# pricing_scan calls per layout that ran (pricing_layout) since the last
# reset_launches(): a float64 call that falls back to "split" shows here
pricing_layouts = {"split": 0, "stream": 0}
# rank-1 launches by kind since the last reset_launches(): the update alone,
# or with the next step's ftran fused in
rank1_layouts = {"plain": 0, "ftran": 0}

# pricing pass 1 splits the rows into chunks so that about this many blocks
# of 1024 columns are in flight (8 per SM on a 132-SM H100)
_PRICING_TARGET_BLOCKS = 1056
_PRICING_COLS_PER_BLOCK = 1024
_PRICING_MIN_ROWS = 32
_PRICING_REDUCE_COLS = 32  # columns a block of pass 2 owns
# the stream layout of float64 pricing (csrc/pricing_scan.cu kStream*): a
# work item's columns (two a thread of a 128-thread CTA) and the CTAs an SM
_PRICING_STREAM_COLS, _PRICING_STREAM_CTAS = 256, 3


def reset_launches() -> None:
    for counter in (launches, pricing_layouts, rank1_layouts):
        for name in counter:
            counter[name] = 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# The checks below run on every launch of a host-bound loop: they format
# their message only when they fail.


def _vector(t: torch.Tensor, n: int, dtype: torch.dtype, name: str) -> None:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != ({n},)")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _scalar(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.numel() != 1 or t.dtype != dtype:
        raise ValueError(f"{name}: want one {dtype} element, got {tuple(t.shape)} {t.dtype}")


_FLOATS = (torch.float32, torch.float64)
# csrc: the element type's code of the single-card kernels (pricing also
# names A's own: the bf16 shadow)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_A_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _working_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The call's float dtype, taken from ``t``: float32 or float64."""
    if t.dtype not in _FLOATS:
        raise ValueError(f"{name}: dtype {t.dtype} (want float32 or float64)")
    return t.dtype


def _value(block: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The 0-d ``dtype`` value a kernel stored in the first words of an int32
    output block (two words for a double, so that it stays 8-byte aligned)."""
    return block[: dtype.itemsize // 4].view(dtype).view(())


def _flag(t: torch.Tensor, name: str) -> None:
    if t.numel() != 1:
        raise ValueError(f"{name}: want one element, got {tuple(t.shape)}")
    if t.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"{name}: dtype {t.dtype}")


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
    e = y.A - c (lowest index on ties). Given ``basis``, BASIC_PENALTY is
    added at the basic columns that fall in [base_col, base_col + n); given
    ``at_upper`` too (the signed mode), e is negated at the at-upper columns
    first."""
    e = _ops.reduced_costs(y, A, c)
    if at_upper is not None:
        e = torch.where(at_upper, -e, e)
    if basis is not None:
        e = _ops.add_basic_penalty(e, basis, base_col)
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


_LAYOUT_CODE = {"split": 0, "stream": 1}
_sms: dict = {}


def _sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors: the stream layout's CTAs."""
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def pricing_layout(
    a_dtype: torch.dtype, dtype: torch.dtype, m: int, n: int, lda: int, aligned: bool,
    chunk_n: Optional[int] = None,
) -> str:
    """The layout of a ``pricing_scan`` call, from its dtypes, shape and
    alignment alone: ``"stream"`` (one persistent launch, pass 2 folded in;
    ``csrc/pricing_scan.cu``) for float64 A with float64 vectors where A's
    rows are whole 16-byte runs (n and lda multiples of 4, A 16-byte
    aligned: ``aligned``) and fall in more than one row chunk; else
    ``"split"`` (the two launches every dtype takes; one where a single
    chunk covers m). Both give the same results to the bit."""
    chunks = _pricing_chunks(m, n if chunk_n is None else chunk_n)[1]
    stream = (
        a_dtype == dtype == torch.float64 and aligned and n % 4 == 0 and lda % 4 == 0 and chunks > 1
    )
    return "stream" if stream else "split"


def pricing_stream_plan(m: int, n: int, chunk_n: Optional[int] = None, sms: int = 132) -> dict:
    """The stream layout's launch, every number of which the kernel takes
    from here: the row chunks of (m, ``chunk_n``) (``rows`` a chunk,
    ``chunks``), ``col_tiles`` of ``_PRICING_STREAM_COLS`` columns (the
    kernel refuses another count) and ``grid`` persistent CTAs,
    ``_PRICING_STREAM_CTAS`` an SM. CTA b walks items w = b, b + grid, ...
    below col_tiles x chunks: chunk w // col_tiles, tile w % col_tiles."""
    rows, chunks = _pricing_chunks(m, n if chunk_n is None else chunk_n)
    col_tiles = -(-n // _PRICING_STREAM_COLS)
    grid = min(col_tiles * chunks, sms * _PRICING_STREAM_CTAS)
    return dict(rows=rows, chunks=chunks, col_tiles=col_tiles, grid=grid)


class _PricingWorkspace:
    """The scratch of one pricing shape and working dtype: the (chunks, n)
    partial sums, the per-block results and the tickets (the split layout's
    one, and the stream layout's one a column tile; 0 between calls). The
    row chunks are those of an (m, chunk_n) pass."""

    def __init__(self, dev: torch.device, m: int, n: int, chunk_n: int, dtype: torch.dtype):
        self.rows, self.chunks = _pricing_chunks(m, chunk_n)
        nblk = -(-n // _PRICING_REDUCE_COLS)
        self.partial = torch.empty((self.chunks, n), dtype=dtype, device=dev)
        self.blk_min = torch.empty(nblk, dtype=dtype, device=dev)
        self.blk_idx = torch.empty((2, nblk), dtype=torch.int32, device=dev)
        self.ticket = torch.zeros(1 + -(-n // _PRICING_STREAM_COLS), dtype=torch.int32, device=dev)


# (device, stream, m, n, chunk_n, dtype) -> workspace; emptied when it
# outgrows its room
_workspaces: dict = {}
_WORKSPACES_MAX = 16


def _pricing_workspace(
    dev: torch.device, stream: int, m: int, n: int, chunk_n: int, dtype: torch.dtype
) -> _PricingWorkspace:
    key = (dev, stream, m, n, chunk_n, dtype)
    ws = _workspaces.get(key)
    if ws is None:
        if len(_workspaces) >= _WORKSPACES_MAX:
            _workspaces.clear()
        ws = _workspaces[key] = _PricingWorkspace(dev, m, n, chunk_n, dtype)
    return ws


def _pricing_call(
    y, A, c, eps, at_upper, basis, base_col, use_bland, p_offset, chunk_n=None, layout=None,
    out=None,
):
    """Checks, then the plain version (CPU tensors) or the kernel's
    launches in the layout :func:`pricing_layout` picks. Returns ``(min_e,
    argmin, first_below, p)``; ``p`` is the entering column chosen under
    ``use_bland`` plus ``p_offset`` (None when ``use_bland`` is None). The
    row chunks are those of an (m, ``chunk_n``) pass (default: A's own
    width). ``layout`` names a layout the call must take (``"split"`` or
    ``"stream"``; ValueError where the call cannot), for the tools that
    hold the two against each other; the solver never passes it. ``out``
    (CUDA only) is the output block to write, as :func:`pricing_block`
    makes it."""
    if A.dim() != 2 or A.shape[0] == 0 or A.shape[1] == 0:
        raise ValueError(f"A: want a non-empty matrix, got {tuple(A.shape)}")
    m, n = A.shape
    dt = _working_dtype(c, "c")
    if A.dtype not in (dt, torch.bfloat16):
        raise ValueError(f"A: dtype {A.dtype} beside {dt} vectors (want {dt} or bfloat16)")
    lda = A.stride(0)
    if A.stride(1) != 1 or (m > 1 and lda < n):
        raise ValueError(
            f"A: want unit column stride and rows at least n apart, got strides {A.stride()}"
        )
    _vector(y, m, dt, "y")
    _vector(c, n, dt, "c")
    ins = (y, A, c)
    if at_upper is not None and basis is None:
        raise ValueError("at_upper and basis go together (the signed mode needs both)")
    if at_upper is not None:
        _vector(at_upper, n, torch.bool, "at_upper")
        ins += (at_upper,)
    if basis is not None:
        _vector(basis, m, torch.int32, "basis")
        ins += (basis,)
    if use_bland is not None:
        _flag(use_bland, "use_bland")
        ins += (use_bland,)
    dev = _same_device(*ins)
    if layout is not None and layout not in _LAYOUT_CODE:
        raise ValueError(f"pricing_scan: no layout {layout!r}")
    if dev.type == "cpu":
        _require(out is None, "pricing_scan: out takes a CUDA block only")
        min_e, p_dantzig, p_neg = pricing_scan_plain(y, A, c, eps, at_upper, basis, base_col)
        p = None
        if use_bland is not None:
            p_bland = torch.where(p_neg == INT_MAX, 0, p_neg)
            p = torch.where(use_bland.view(()).to(torch.bool), p_bland, p_dantzig)
            p = p + p_offset if p_offset else p
        return min_e, p_dantzig, p_neg, p
    lib = _build.load_library()
    stream = _stream(dev)
    chunk_n = n if chunk_n is None else int(chunk_n)
    ws = _pricing_workspace(dev, stream, m, n, chunk_n, dt)
    w = dt.itemsize // 4
    if out is None:
        out = pricing_block(dev, dt)
    else:
        _require(
            out.shape == (w + 3,) and out.dtype == torch.int32 and out.is_contiguous()
            and out.device == dev and not any(_overlaps(out, t) for t in ins),
            "out: want a pricing_block of the call's dtype on its device, apart from the inputs",
        )
    align = 8 if A.dtype == torch.bfloat16 else 16
    aligned = A.data_ptr() % align == 0
    vec = n % 4 == 0 and lda % 4 == 0 and aligned
    picked = pricing_layout(A.dtype, dt, m, n, lda, aligned, chunk_n)
    if layout is not None and layout != picked and layout != "split":
        raise ValueError(f"pricing_scan: layout {layout!r} does not take this call (it takes {picked!r})")
    layout = layout or picked
    plan = (pricing_stream_plan(m, n, chunk_n, _sm_count(dev)) if layout == "stream"
            else dict(rows=ws.rows, chunks=ws.chunks, col_tiles=0, grid=0))
    spans.mark("launch:pricing_scan")
    err = lib.simplex_pricing_scan(
        _LAYOUT_CODE[layout], _A_CODE[A.dtype], _DTYPE_CODE[dt],
        y.data_ptr(), A.data_ptr(), c.data_ptr(),
        None if at_upper is None else at_upper.data_ptr(),
        None if basis is None else basis.data_ptr(), m, int(base_col),
        m, n, lda, eps, plan["rows"], plan["chunks"], int(vec),
        None if use_bland is None else use_bland.data_ptr(),
        int(use_bland is not None and use_bland.dtype == torch.bool),
        int(p_offset), ws.partial.data_ptr(), ws.blk_min.data_ptr(),
        ws.blk_idx[0].data_ptr(), ws.blk_idx[1].data_ptr(),
        ws.ticket.data_ptr(), out.data_ptr(), plan["grid"], plan["col_tiles"], stream,
    )
    if err != 0:
        # a refused launch may leave the ticket taken: drop the workspace
        _workspaces.pop((dev, stream, m, n, chunk_n, dt), None)
    _build.check(err, "pricing_scan")
    launches["pricing_scan"] += 1
    pricing_layouts[layout] += 1
    p_dantzig, p_neg, p = out[w:].unbind(0)
    return _value(out, dt), p_dantzig, p_neg, p


def pricing_block(dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A new output block of one pricing call: min_e as a ``dtype`` value
    (one or two int32 words), then argmin, first below -eps and the chosen
    column."""
    return torch.empty(dtype.itemsize // 4 + 3, dtype=torch.int32, device=dev)


def pricing_choice(block: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p, min_e)``: the views of a :func:`pricing_block` that
    :func:`choose_entering` returns."""
    return block[-1], _value(block, dtype)


def pricing_scan(
    y: torch.Tensor, A: torch.Tensor, c: torch.Tensor, eps: float,
    at_upper: Optional[torch.Tensor] = None, basis: Optional[torch.Tensor] = None,
    base_col: int = 0, chunk_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over A: ``(min_e, argmin_e, first index with e < -eps or
    INT_MAX)`` as 0-d device tensors, e = y.A - c never stored.

    y (m,) and c (n,) contiguous, both float32 or both float64 (the working
    dtype, in which the sums run and min_e comes out); A (m, n) of the same
    dtype or bfloat16 (upcast per element) with unit column stride: a
    contiguous matrix or a column range of one (``A_price[:, s*w:(s+1)*w]``),
    scanned in place; all on one device. Given ``basis`` (int32,
    contiguous, global column indices), BASIC_PENALTY is added at the basic
    columns, A being columns [base_col, base_col + n) of the problem's; given
    ``at_upper`` (n,) bool too (the signed mode of the bounded rule, basis
    (m,)), the scan runs over s = (at_upper ? -e : e) plus that penalty.

    Two launches on the current stream (one where a single row chunk covers
    m, as for m <= 32), or in float64 one (the stream layout,
    :func:`pricing_layout`). The scratch (partial sums, per-block
    results, the tickets that elect the reducing blocks) is kept per (device,
    stream, m, n, chunk_n, dtype) and reused: the calls that share it are ordered by their
    stream, and the last launch resets the tickets. Launching the same
    shape on one stream from two host threads at once, or replaying a
    captured call beside a live one, would break that; a launch error drops
    the workspace. Only the 4-word output block is allocated per call.

    Each column's sum runs over row chunks fixed by (m, ``chunk_n``)
    (default: A's width n). A column shard of a wider matrix passes the
    full width, so that its sums are bit for bit those of the pass over
    the whole matrix.
    """
    return _pricing_call(y, A, c, eps, at_upper, basis, base_col, None, 0, chunk_n)[:3]


def choose_entering_plain(y, A, c, eps, use_bland, basis=None, base_col: int = 0):
    """The masked choice of the entering column as plain torch ops
    (:func:`simplex_tpu_torch.kernels.ops.choose_entering`)."""
    return _ops.choose_entering(y, A, c, eps, use_bland, basis, base_col)


def choose_entering(
    y, A, c, eps, use_bland, basis: Optional[torch.Tensor] = None, base_col: int = 0,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`simplex_tpu_torch.kernels.ops.choose_entering`
    in one :func:`pricing_scan` call: the basic-column mask, the choice
    between Dantzig's and Bland's column (``use_bland`` read on the device)
    and the ``base_col`` offset are made by the kernel, so no torch op runs
    before or after it. A sparse A (:class:`~simplex_tpu_torch.sparse.SparseA`)
    is priced by its SpMV and the masked argmin as plain ops: the kernel
    reads dense A. ``out`` (dense A on CUDA only): the :func:`pricing_block`
    the kernel writes, of which p and min_e are views (:func:`pricing_choice`),
    for a CUDA graph whose results have to outlive its capture."""
    if isinstance(A, _sp.SparseA):
        _require(out is None, "choose_entering: out takes dense A only")
        return _ops.choose_entering(y, A, c, eps, use_bland, basis, base_col)
    min_e, _, _, p = _pricing_call(
        y, A, c, eps, None, basis, base_col, use_bland, base_col, out=out
    )
    return p, min_e


def choose_entering_bounded(
    y, A, c, at_upper, basis, base_col, eps, use_bland
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as
    :func:`simplex_tpu_torch.kernels.ops.choose_entering_bounded`, through
    :func:`pricing_scan`'s signed mode: one pass over A (fp32, the bf16
    shadow or a segment view of either), no fp32 copy of a bf16 A, and the
    basic-column penalty, the choice and the segment offset made inside the
    same call. Sparse A takes the plain ops, as in :func:`choose_entering`."""
    if isinstance(A, _sp.SparseA):
        return _ops.choose_entering_bounded(y, A, c, at_upper, basis, base_col, eps, use_bland)
    min_s, _, _, p = _pricing_call(y, A, c, eps, at_upper, basis, base_col, use_bland, base_col)
    return p, min_s


# --------------------------------------------------------------------------
# classic masked ratio test
# --------------------------------------------------------------------------


_RATIO_BLOCK_ROWS = 1024
_RATIO_MAX_CLUSTER = 8


def _ratio_cluster(m: int) -> int:
    """Blocks of 1024 threads in a ratio kernel's cluster
    (``csrc/ratio_cluster.cuh``): one row a thread up to 8 blocks, a stride
    loop beyond."""
    return min(_RATIO_MAX_CLUSTER, -(-m // _RATIO_BLOCK_ROWS))


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
    launch of a thread block cluster sized by m (:func:`_ratio_cluster`),
    every result a 0-d device tensor and a view of one int32 block. x_b,
    alpha (m,) both float32 or both float64; basis (m,) int32; use_bland a
    one-element bool or int32 tensor, read on the device as it is. Any m."""
    m = x_b.shape[0] if x_b.dim() == 1 else -1
    if m <= 0:
        raise ValueError(f"x_b: want a non-empty vector, got {tuple(x_b.shape)}")
    dt = _working_dtype(x_b, "x_b")
    _vector(x_b, m, dt, "x_b")
    _vector(alpha, m, dt, "alpha")
    _vector(basis, m, torch.int32, "basis")
    _flag(use_bland, "use_bland")
    dev = _same_device(x_b, alpha, basis, use_bland)
    if dev.type == "cpu":
        return ratio_argmin_plain(x_b, alpha, basis, pivot_tol, use_bland)
    lib = _build.load_library()
    # q, theta_q as a dt value from word w on, and the unbounded flag in the
    # last word's first byte
    w = dt.itemsize // 4
    out = torch.empty(2 * w + 1, dtype=torch.int32, device=dev)
    spans.mark("launch:ratio_argmin")
    err = lib.simplex_ratio_argmin(
        _DTYPE_CODE[dt], x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(),
        use_bland.data_ptr(), int(use_bland.dtype == torch.bool), m, pivot_tol,
        _ratio_cluster(m), out.data_ptr(), out[w].data_ptr(), out[2 * w].data_ptr(),
        _stream(dev),
    )
    _build.check(err, "ratio_argmin")
    launches["ratio_argmin"] += 1
    return out[0], _value(out[w:], dt), out[2 * w:].view(torch.bool)[0]


# --------------------------------------------------------------------------
# fused ratio test + eta + x_b step, and the pivot's whole O(m) tail
# --------------------------------------------------------------------------

_FLAG_BYTES = 4  # csrc/ratio_eta.cu: the flag block
PivotTail = _ops.PivotTail


def _scalar_block(dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """csrc/ratio_eta.cu's scalar block: q, theta_q at word w (w = 1 for
    float32, 2 for float64, after a pad word), iters, status, degen, npend."""
    return torch.empty(2 * (dtype.itemsize // 4) + 4, dtype=torch.int32, device=dev)


def _scalar_views(
    scal: torch.Tensor, flags: torch.Tensor, dtype: torch.dtype = torch.float32
) -> dict:
    """The scalar block's values and the flag bytes as 0-d tensors (theta_q
    is stored as a ``dtype`` value in its own words)."""
    w = dtype.itemsize // 4
    iters, status, degen, npend = scal[2 * w:].unbind(0)
    optimal, unbounded, bad, take = flags.unbind(0)
    return {
        "q": scal[0], "theta_q": _value(scal[w:], dtype), "iters": iters, "status": status,
        "degen": degen, "npend": npend, "optimal": optimal, "unbounded": unbounded,
        "bad": bad, "take": take,
    }


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
    """``(q, theta_q, unbounded, eta, x_b_new)`` in one launch of the
    cluster kernel with its tail off, every result on the device. x_b, alpha
    (m,) both float32 or both float64; basis (m,) int32; use_bland a
    one-element bool or int32 tensor, read on the device as it is. eta and x_b_new are computed as if
    the pivot proceeds; the caller discards them on a terminal step. Two
    small allocations for the scalars and flags, one (2, m) block for eta and
    x_b_new."""
    m = x_b.shape[0] if x_b.dim() == 1 else -1
    if m <= 0:
        raise ValueError(f"x_b: want a non-empty vector, got {tuple(x_b.shape)}")
    dt = _working_dtype(x_b, "x_b")
    _vector(x_b, m, dt, "x_b")
    _vector(alpha, m, dt, "alpha")
    _vector(basis, m, torch.int32, "basis")
    _flag(use_bland, "use_bland")
    dev = _same_device(x_b, alpha, basis, use_bland)
    if dev.type == "cpu":
        return ratio_eta_plain(x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol)
    lib = _build.load_library()
    scal = _scalar_block(dev, dt)
    flags = torch.empty(_FLAG_BYTES, dtype=torch.bool, device=dev)
    eta, x_b_new = torch.empty((2, m), dtype=dt, device=dev).unbind(0)
    spans.mark("launch:ratio_eta")
    err = lib.simplex_ratio_eta(
        _DTYPE_CODE[dt], x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(), use_bland.data_ptr(),
        int(use_bland.dtype == torch.bool), m, pivot_tol, feas_tol,
        int(bool(harris)), _ratio_cluster(m), scal.data_ptr(), flags.data_ptr(),
        eta.data_ptr(), x_b_new.data_ptr(), _stream(dev),
    )
    _build.check(err, "ratio_eta")
    launches["ratio_eta"] += 1
    v = _scalar_views(scal, flags, dt)
    return v["q"], v["theta_q"], v["unbounded"], eta, x_b_new


def pivot_tail_plain(
    x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen, *,
    eps, pivot_tol, feas_tol, harris, degen_tol, bland_after,
    U=None, R=None, npend=0, npend_t=None,
) -> PivotTail:
    """The torch composition the tail kernel replaces
    (:func:`simplex_tpu_torch.kernels.ops.pivot_tail`)."""
    return _ops.pivot_tail(
        x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen,
        eps=eps, pivot_tol=pivot_tol, feas_tol=feas_tol, harris=harris,
        degen_tol=degen_tol, bland_after=bland_after, U=U, R=R, npend=npend,
        npend_t=npend_t,
    )


def pivot_tail(
    x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen, *,
    eps: float, pivot_tol: float, feas_tol: float, harris: bool,
    degen_tol: float, bland_after: int,
    U: Optional[torch.Tensor] = None, R: Optional[torch.Tensor] = None,
    npend: int = 0, npend_t: Optional[torch.Tensor] = None,
    out: Optional[tuple] = None,
) -> PivotTail:
    """Everything an unbounded pivot step does after the ftran, in ONE
    launch: the ratio test on (x_b, alpha, basis) with Bland's rule on when
    ``degen >= bland_after > 0`` (read on the device); the step's decisions
    (optimal iff ``min_e >= -eps``, unbounded, bad, take); eta and the copy
    of row q of the true inverse, both zero when the step does not pivot;
    and x_b, y, c_b, basis, iters, status and degen as the step stores them
    (unchanged when it does not pivot). See
    :func:`simplex_tpu_torch.kernels.ops.pivot_tail` for each formula.

    Every float operand in one dtype, float32 or float64: x_b, alpha, y,
    c_b (m,) and basis (m,) int32, contiguous; B_inv (m, m) contiguous;
    min_e, e_p, c_p one-element and p, iters, degen one-element int32
    tensors. Deferred updates: U, R (L, m) contiguous with ``npend`` < L
    pending pairs (the host's count) and ``npend_t`` its device scalar; the
    kernel adds the pending pairs to
    row q in pair order and writes the new pair straight into row ``npend``
    of U and R (the returned ``eta`` and ``row`` are those rows). Against
    the plain version's matrix product that sum differs in the last bits
    (row and y to rtol 1e-6 in float32, 1e-12 in float64); every other result
    is bitwise equal.

    Three allocations: one (k, m) block for the vector outputs, one block
    for the int32 scalars and one for the four flags; every result is a
    view of one of them. ``out`` (CUDA only) gives the three blocks
    instead, as :func:`tail_blocks` makes them: a CUDA graph of the step
    writes its state into buffers that outlive the capture
    (:mod:`simplex_tpu_torch.core.graph`)."""
    m = x_b.shape[0] if x_b.dim() == 1 else -1
    if m <= 0:
        raise ValueError(f"x_b: want a non-empty vector, got {tuple(x_b.shape)}")
    dt = _working_dtype(x_b, "x_b")
    _vector(x_b, m, dt, "x_b")
    _vector(alpha, m, dt, "alpha")
    _vector(y, m, dt, "y")
    _vector(c_b, m, dt, "c_b")
    _vector(basis, m, torch.int32, "basis")
    if B_inv.shape != (m, m) or B_inv.dtype != dt or not B_inv.is_contiguous():
        raise ValueError(f"B_inv: want contiguous {dt} ({m}, {m}), got {tuple(B_inv.shape)} {B_inv.dtype}")
    _scalar(min_e, dt, "min_e")
    _scalar(e_p, dt, "e_p")
    _scalar(c_p, dt, "c_p")
    _scalar(p, torch.int32, "p")
    _scalar(iters, torch.int32, "iters")
    _scalar(degen, torch.int32, "degen")
    ins = [x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen]
    defer = U is not None
    if (R is not None) != defer or (npend_t is not None) != defer:
        raise ValueError("U, R and npend_t go together")
    if defer:
        L = U.shape[0] if U.dim() == 2 else -1
        for name, t in (("U", U), ("R", R)):
            if t.shape != (L, m) or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"{name}: want contiguous {dt} ({L}, {m}), got {tuple(t.shape)} {t.dtype}")
        if not 0 <= npend < L:
            raise ValueError(f"npend {npend} outside [0, {L})")
        _scalar(npend_t, torch.int32, "npend_t")
        ins += [U, R, npend_t]
    elif npend != 0:
        raise ValueError("npend without U and R")
    dev = _same_device(*ins)
    if dev.type == "cpu":
        _require(out is None, "pivot_tail: out takes CUDA blocks only")
        return pivot_tail_plain(
            x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen,
            eps=eps, pivot_tol=pivot_tol, feas_tol=feas_tol, harris=harris,
            degen_tol=degen_tol, bland_after=bland_after, U=U, R=R, npend=npend,
            npend_t=npend_t,
        )
    if out is None:
        out = tail_blocks(dev, dt, m, defer)
    else:
        _tail_out(out, dev, dt, m, defer, ins)
    lib = _build.load_library()
    block, scal, flags = out
    vecs = block.unbind(0)
    eta, row = (U[npend], R[npend]) if defer else vecs[4:]
    basis_out = vecs[3].view(torch.int32)[:m]
    st = SolveStatus
    spans.mark("launch:pivot_tail")
    err = lib.simplex_pivot_tail(
        _DTYPE_CODE[dt], x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(), y.data_ptr(),
        c_b.data_ptr(), B_inv.data_ptr(),
        U.data_ptr() if defer else None, R.data_ptr() if defer else None, int(npend),
        min_e.data_ptr(), e_p.data_ptr(), c_p.data_ptr(), p.data_ptr(),
        iters.data_ptr(), degen.data_ptr(), npend_t.data_ptr() if defer else None,
        m, eps, pivot_tol, feas_tol, degen_tol, int(bool(harris)), int(bland_after),
        int(st.RUNNING), int(st.OPTIMAL), int(st.UNBOUNDED), int(st.SINGULAR),
        _ratio_cluster(m), eta.data_ptr(), row.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), vecs[2].data_ptr(), basis_out.data_ptr(),
        scal.data_ptr(), flags.data_ptr(), _stream(dev),
    )
    _build.check(err, "ratio_eta")
    launches["ratio_eta"] += 1
    return _tail_views(vecs, basis_out, scal, flags, dt, eta, row, defer)


def _tail_views(vecs, basis, scal, flags, dt, eta, row, defer: bool) -> PivotTail:
    v = _scalar_views(scal, flags, dt)
    return PivotTail(
        x_b=vecs[0], y=vecs[1], c_b=vecs[2], basis=basis, iters=v["iters"],
        status=v["status"], degen=v["degen"], npend=v["npend"] if defer else None,
        eta=eta, row=row, q=v["q"], theta_q=v["theta_q"], optimal=v["optimal"],
        unbounded=v["unbounded"], bad=v["bad"], take=v["take"],
    )


def tail_blocks(dev: torch.device, dtype: torch.dtype, m: int, defer: bool = False) -> tuple:
    """New output blocks of one :func:`pivot_tail` call, ``(vectors,
    scalars, flags)``: (k, m) ``dtype`` rows x_b, y, c_b and the basis (its
    int32 words at the start of the fourth row), then eta and row unless
    ``defer`` (k = 6, else 4); the int32 scalar block; the four flags."""
    block = torch.empty((4 if defer else 6, m), dtype=dtype, device=dev)
    return block, _scalar_block(dev, dtype), torch.empty(_FLAG_BYTES, dtype=torch.bool, device=dev)


def tail_outputs(out: tuple, dtype: torch.dtype) -> PivotTail:
    """The views a non-deferred :func:`pivot_tail` call returns when it
    writes into ``out`` (:func:`tail_blocks`)."""
    block, scal, flags = out
    vecs = block.unbind(0)
    basis = vecs[3].view(torch.int32)[: block.shape[1]]
    return _tail_views(vecs, basis, scal, flags, dtype, vecs[4], vecs[5], False)


def _tail_out(out, dev, dt, m, defer, ins) -> None:
    """Checks of the blocks a caller gives :func:`pivot_tail`: as
    :func:`tail_blocks` makes them, on ``dev``, and apart from every
    input (the kernel reads the inputs while it writes the blocks)."""
    _require(isinstance(out, tuple) and len(out) == 3, "out: want (vectors, scalars, flags)")
    block, scal, flags = out
    want = ((block, (4 if defer else 6, m), dt), (scal, (2 * (dt.itemsize // 4) + 4,), torch.int32),
            (flags, (_FLAG_BYTES,), torch.bool))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"out: want contiguous {dtype} {shape} on {dev}, got {tuple(t.shape)} {t.dtype}")
        _require(not any(_overlaps(t, x) for x in ins), "out: overlaps an input")


def pricing_scratch(A: torch.Tensor, dtype: torch.dtype, stream: torch.cuda.Stream):
    """The scratch of a :func:`pricing_scan` over all of A with ``dtype``
    vectors launched on ``stream``, made now if it is not kept yet. A CUDA
    graph captured on ``stream`` has to find it made (a capture would
    record the zeroing of its tickets into every replay) and must hold it
    for as long as it lives (the cache here may drop it)."""
    m, n = A.shape
    return _pricing_workspace(A.device, stream.cuda_stream, m, n, n, dtype)


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
    """``B_inv += eta (x) binv_q`` IN PLACE; returns B_inv. B_inv (r, m)
    contiguous with 0 < r <= m: the whole (m, m) inverse, or a block of its
    rows (the 2-D sharded solve's row block); eta (r,) and binv_q (m,);
    all three float32 or all three float64; neither vector overlapping B_inv (row q of B_inv must be
    passed as a copy, ``B_inv[q].clone()``)."""
    _require(
        B_inv.dim() == 2 and 0 < B_inv.shape[0] <= B_inv.shape[1],
        f"B_inv: want a non-empty block of rows of a square matrix, got {tuple(B_inv.shape)}",
    )
    r, m = B_inv.shape
    dt = _working_dtype(B_inv, "B_inv")
    _require(B_inv.is_contiguous(), "B_inv: not contiguous")
    _vector(eta, r, dt, "eta")
    _vector(binv_q, m, dt, "binv_q")
    dev = _same_device(B_inv, eta, binv_q)
    _require(
        not _overlaps(binv_q, B_inv) and not _overlaps(eta, B_inv),
        "rank1_update: eta / binv_q overlap B_inv (pass a copy of the row)",
    )
    if dev.type == "cpu":
        return rank1_update_plain(B_inv, eta, binv_q)
    lib = _build.load_library()
    vec = m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (B_inv, binv_q))
    spans.mark("launch:rank1_update")
    err = lib.simplex_rank1_update(
        _DTYPE_CODE[dt], B_inv.data_ptr(), eta.data_ptr(), binv_q.data_ptr(), r, m, int(vec),
        _stream(dev),
    )
    _build.check(err, "rank1_update")
    launches["rank1_update"] += 1
    rank1_layouts["plain"] += 1
    return B_inv


def rank1_update_ftran_plain(B_inv, eta, binv_q, a, out=None) -> torch.Tensor:
    """The update, then ``B_inv @ a`` (:func:`simplex_tpu_torch.kernels.ops.
    rank1_update_ftran`)."""
    return _ops.rank1_update_ftran(B_inv, eta, binv_q, a, out)


def rank1_update_ftran(
    B_inv: torch.Tensor, eta: torch.Tensor, binv_q: torch.Tensor, a: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`rank1_update` of a whole (m, m) inverse, IN PLACE, and the
    product ``alpha = B_inv a`` of the updated inverse, in ONE launch: the
    pass that writes B_inv sums alpha from the values it writes, so the
    inverse is read once for both (the next step's ftran). The update
    equals :func:`rank1_update`'s bit for bit; alpha is summed in a fixed
    order (the same from call to call, and within rounding of
    ``torch.mv``). B_inv (m, m), eta, binv_q and a (m,), all float32 or all
    float64, no vector overlapping B_inv. Returns alpha, new or written into
    ``out`` ((m,) contiguous, apart from every input). Counted under
    ``launches["rank1_update"]`` and ``rank1_layouts["ftran"]``."""
    _require(
        B_inv.dim() == 2 and B_inv.shape[0] == B_inv.shape[1] > 0,
        f"B_inv: want a non-empty square matrix, got {tuple(B_inv.shape)}",
    )
    m = B_inv.shape[0]
    dt = _working_dtype(B_inv, "B_inv")
    _require(B_inv.is_contiguous(), "B_inv: not contiguous")
    _vector(eta, m, dt, "eta")
    _vector(binv_q, m, dt, "binv_q")
    _vector(a, m, dt, "a")
    ins = (B_inv, eta, binv_q, a)
    dev = _same_device(*ins) if out is None else _same_device(*ins, out)
    _require(
        not any(_overlaps(t, B_inv) for t in (eta, binv_q, a)),
        "rank1_update_ftran: eta / binv_q / a overlap B_inv (pass a copy of the row)",
    )
    if out is not None:
        _vector(out, m, dt, "out")
        _require(not any(_overlaps(out, t) for t in ins), "out: overlaps an input")
    if dev.type == "cpu":
        return rank1_update_ftran_plain(B_inv, eta, binv_q, a, out)
    if out is None:
        out = torch.empty(m, dtype=dt, device=dev)
    lib = _build.load_library()
    vec = m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (B_inv, binv_q, a))
    spans.mark("launch:rank1_update")
    err = lib.simplex_rank1_update_ftran(
        _DTYPE_CODE[dt], B_inv.data_ptr(), eta.data_ptr(), binv_q.data_ptr(), a.data_ptr(),
        out.data_ptr(), m, int(vec), _stream(dev),
    )
    _build.check(err, "rank1_update_ftran")
    launches["rank1_update"] += 1
    rank1_layouts["ftran"] += 1
    return out



# --------------------------------------------------------------------------
# the batched kernels (simplex_tpu_torch.batch): one launch a batch step each
# --------------------------------------------------------------------------


def _batched(t: torch.Tensor, shape: tuple, dtype: torch.dtype, name: str) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


_BATCH_GRID_MAX = 65535  # grid.y: the instances, or the shared layout's instance tiles

# csrc/batch_pricing.cu: the per-instance chunk (columns a block), the shared
# layout's CTA tile (instances x columns), a record's 32-bit words by the
# vectors' bytes (simplex_batch_pricing_record_bytes); the window's
# bulk-copy chunk and its threads (fp32 or fp64, bf16), the grouped window's
# CTA tile and most windows; with float64 vectors the shared product's and
# the grouped window's CTA tiles on the FP64 tensor cores (instances,
# columns, threads of the mma; the shared product by bulk copies adds a
# producer warp); the launch's layout codes
_BP_CHUNK = 256
_BP_TILE_B, _BP_TILE_N = 64, 128
_BP_DMMA_TILE = (128, 64, 256)
_BP_DMMA_GROUP_TILE = (32, 64, 256)
_BP_DMMA_K = 4  # the m16n8kK mma shape of both (csrc/batch_pricing.cu kDmmaK)
_BP_RECORD_WORDS = {4: 3, 8: 4}
_BP_TMA_CHUNK = 256
_BP_TMA_THREADS = {False: 256 + 32, True: 64 + 32}
_BP_TMA_CLUSTER_MAX = 8  # chunks an instance that merge in one cluster
_BP_GROUP_TILE = (16, 32)
_BP_GROUP_MAX_S = 1024
_BP_LAYOUTS = {"scan": 0, "bf16x4": 1, "shared": 2, "shared_loads": 3, "window_tma": 4,
               "window_group": 5, "window_group_loads": 6}


def _alignment(*ts: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    a = 16
    for t in ts:
        ptr = t.data_ptr()
        while ptr % a:
            a //= 2
    return a


def batch_pricing_plan(
    Bn: int, m: int, n: int, *, shared: bool, bf16: bool, align: int, window: int = 0,
    segments: int = 0, elem: int = 4,
) -> dict:
    """How :func:`choose_entering_batched` launches ``csrc/batch_pricing.cu``
    for B = ``Bn`` instances of m x n, A per instance or ``shared``, the
    vectors of ``elem`` bytes (4: fp32, 8: fp64) and A of their type or the
    ``bf16`` shadow, its pointers aligned to ``align`` bytes (y's and A's),
    every column or a ``window`` of that many columns an instance out of
    ``segments`` (S). The 16-byte copy conditions below count A's bytes (2,
    4 or 8 an element):

    ``layout``: "scan" (per instance, a column a thread), "bf16x4" (per
    instance, the bf16 shadow at n % 4 == 0: four columns a thread), "shared"
    (one A: the tiled product fed by 16-byte copies, which need m % 4 == 0,
    rows of a multiple of 16 bytes and 16-byte alignment) or
    "shared_loads" (the same product fed by element loads). A window of a
    per-instance A takes "window_tma" (a producer warp's bulk copies into a
    ring of shared memory, which need m % 4 == 0, n and w of a multiple of
    16 bytes and 16-byte alignment), else "scan", or "bf16x4" where w is a
    multiple of 4; a window of a shared A takes "window_group" (instances
    grouped by window on the device, then the tiled product on 16-byte
    copies: the shared layout's conditions and w of a multiple of 16 bytes)
    or "window_group_loads" (element loads), and the scan at an instance
    stride of 0 beyond ``_BP_GROUP_MAX_S`` windows. With 8-byte vectors
    the shared product and the grouped window run on the FP64 tensor cores
    in CTA tiles of ``_BP_DMMA_TILE`` and ``_BP_DMMA_GROUP_TILE``
    (instances, columns, threads; "shared" then streams by bulk tensor
    copies through a producer warp of 32 threads more), the grouped window
    in instance tiles of 32. ``grid`` and
    ``threads`` of the main launch (the grouped window: one row of
    ``ceil(B / 16) + S - 1`` instance tiles, the surplus returning at
    once); ``chunks`` records an instance; ``reduce``, whether a
    reduction launch merges them (not for one chunk, where the main launch
    writes the choice, nor for the bulk-copy scan's chunks up to
    ``_BP_TMA_CLUSTER_MAX``, which run as one thread block cluster and merge
    through distributed shared memory); ``words`` of the
    basic-column mask an instance; ``group_tiles``; ``scratch_words``, the
    int32 words of scratch (mask, the grouping's permutation, offsets and
    tiles, then the records, 8-byte aligned in fp64); ``launches``, the
    kernels the call runs. Raises where a grid would be too tall."""
    if window and segments < 1:
        raise ValueError("batch_pricing_plan: a window needs its number of segments")
    if elem not in _BP_RECORD_WORDS:
        raise ValueError(f"batch_pricing_plan: vectors of {elem} bytes (want 4 or 8)")
    vec_bytes, elem = elem, 2 if bf16 else elem
    copies = m % 4 == 0 and (n * elem) % 16 == 0 and align >= 16
    words = tiles = group = 0
    if window and shared and segments <= _BP_GROUP_MAX_S:
        tb, tn = _BP_GROUP_TILE
        threads = 64
        if vec_bytes == 8:
            tb, tn, threads = _BP_DMMA_GROUP_TILE
        chunks, words = -(-window // tn), -(-n // 32)
        tiles = -(-Bn // tb) + segments - 1
        layout = "window_group" if copies and (window * elem) % 16 == 0 else "window_group_loads"
        grid = (chunks, tiles)
        group = Bn + segments + 1 + 3 * tiles
    elif window and not shared and copies and (window * elem) % 16 == 0:
        chunks = -(-window // _BP_TMA_CHUNK)
        layout, threads = "window_tma", _BP_TMA_THREADS[bf16]
        grid = (chunks, Bn)
    elif window:
        chunks = -(-window // _BP_CHUNK)
        quads = bf16 and n % 4 == 0 and window % 4 == 0 and align >= 8
        layout, threads = ("bf16x4", 64) if quads else ("scan", 256)
        grid = (chunks, Bn)
    elif shared:
        tb, tn, threads = _BP_DMMA_TILE if vec_bytes == 8 else (_BP_TILE_B, _BP_TILE_N, 256)
        chunks, words = -(-n // tn), -(-n // 32)
        layout = "shared" if copies else "shared_loads"
        threads += 32 if vec_bytes == 8 and copies else 0
        grid = (chunks, -(-Bn // tb))
    else:
        chunks = -(-n // _BP_CHUNK)
        quads = bf16 and n % 4 == 0 and align >= 8
        layout, threads = ("bf16x4", 64) if quads else ("scan", 256)
        grid = (chunks, Bn)
    if grid[1] > _BATCH_GRID_MAX:
        raise ValueError(f"batch_pricing: {Bn} instances need a grid taller than {_BATCH_GRID_MAX}")
    reduce = chunks > (_BP_TMA_CLUSTER_MAX if layout == "window_tma" else 1)
    recs = Bn * chunks * _BP_RECORD_WORDS[vec_bytes] if reduce else 0
    pad = (Bn * words + group) % 2 if recs and vec_bytes == 8 else 0
    return dict(layout=layout, grid=grid, threads=threads, chunks=chunks, reduce=reduce,
                words=words, group_tiles=tiles, scratch_words=Bn * words + group + pad + recs,
                launches=int(words > 0) + 1 + int(reduce))


def window_groups(seg: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm (B,) int32, offsets (S + 1,) int32)``: the instances grouped
    by window s = seg mod S, ascending inside each window, window s at
    perm[offsets[s] : offsets[s + 1]] (the grouped window's first step). On
    a CUDA tensor it runs that step alone, the grouping block of
    ``csrc/batch_pricing.cu`` (uncounted: no pricing call runs it so); on
    the CPU :func:`simplex_tpu_torch.kernels.ops.window_groups`."""
    Bn = seg.shape[0]
    _batched(seg, (Bn,), torch.int32, "seg")
    _require(Bn >= 1 and 1 <= S <= _BP_GROUP_MAX_S, f"window_groups: {Bn} instances, S = {S}")
    if seg.device.type == "cpu":
        return _ops.window_groups(seg, S)
    tiles = -(-Bn // _BP_GROUP_TILE[0]) + S - 1
    group = torch.empty(Bn + S + 1 + 3 * tiles, dtype=torch.int32, device=seg.device)
    err = _build.load_library().simplex_batch_pricing_groups(
        seg.data_ptr(), Bn, S, tiles, group.data_ptr(), _stream(seg.device))
    _build.check(err, "batch_pricing groups")
    return group[:Bn], group[Bn:Bn + S + 1]


def choose_entering_batched_plain(y, A, c, eps, use_bland, basis, at_upper=None, window=None):
    """The per-instance masked choice as plain torch ops
    (:func:`simplex_tpu_torch.kernels.ops.choose_entering_batched`)."""
    return _ops.choose_entering_batched(y, A, c, eps, use_bland, basis, at_upper, window)


def choose_entering_batched(
    y: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
    basis: torch.Tensor,
    at_upper: Optional[torch.Tensor] = None,
    window=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p (B,) int32, min_e (B,))``: the contract of
    :func:`simplex_tpu_torch.kernels.ops.choose_entering_batched` in one
    call of ``csrc/batch_pricing.cu`` (:func:`batch_pricing_plan`: per
    instance one launch where 256 columns cover n, two beyond; a shared A
    a mask launch, the tiled product and a reduction beyond 128 columns
    (float64: the product on the FP64 tensor cores, a reduction beyond 64);
    a ``window = (w, S, seg)`` of a per-instance A one launch of the
    bulk-copy scan up to 8 chunks of 256 columns, two beyond, of a shared A a
    launch that groups the instances by window (and writes the mask), the
    tiled product over each window and a reduction beyond 32 columns
    (float64: beyond 64); its
    starts (seg[i] mod S) * w worked out on the device from seg, an int32
    (B,) tensor; bit for bit the unwindowed call on each instance's slice
    with the start added to the pick).
    y (B, m) and c, (B, n) or a shared (n,), both float32 or both float64
    (the working dtype, in which the sums run and min_e comes out); A
    dense, contiguous, of the same dtype or the bfloat16 shadow: per
    instance (B, m, n), or one (m, n) every instance shares. use_bland (B,)
    bool; basis (B, m) int32; at_upper (B, n) bool for the signed mode. A
    sparse A has no kernel here: its caller prices it
    (``simplex_tpu_torch.batch.step``)."""
    if not isinstance(A, torch.Tensor) or A.dim() not in (2, 3) or 0 in A.shape:
        raise ValueError("A: want a dense (B, m, n) stack or a shared (m, n) matrix")
    m, n = A.shape[-2:]
    Bn = y.shape[0]
    if A.dim() == 3 and A.shape[0] != Bn:
        raise ValueError(f"A: {A.shape[0]} instances, y has {Bn}")
    dt = _working_dtype(c, "c")
    if A.dtype not in (dt, torch.bfloat16) or not A.is_contiguous():
        raise ValueError(f"A: want contiguous {dt} or bfloat16 beside {dt} vectors, got {A.dtype}")
    _batched(y, (Bn, m), dt, "y")
    _batched(c, (n,) if c.dim() == 1 else (Bn, n), dt, "c")
    _batched(use_bland, (Bn,), torch.bool, "use_bland")
    _batched(basis, (Bn, m), torch.int32, "basis")
    ins = [y, A, c, use_bland, basis]
    if at_upper is not None:
        _batched(at_upper, (Bn, n), torch.bool, "at_upper")
        ins.append(at_upper)
    w = S = 0
    if window is not None:
        w, S, seg = window
        _batched(seg, (Bn,), torch.int32, "window seg")
        _require(w >= 1 and S >= 1 and S * w <= n, f"window: {S} segments of {w} columns exceed n = {n}")
        ins.append(seg)
    dev = _same_device(*ins)
    if dev.type == "cpu":
        return choose_entering_batched_plain(y, A, c, eps, use_bland, basis, at_upper, window)
    plan = batch_pricing_plan(Bn, m, n, shared=A.dim() == 2, bf16=A.dtype == torch.bfloat16,
                              align=_alignment(y, A), window=w, segments=S, elem=dt.itemsize)
    lib = _build.load_library()
    scratch = None
    if plan["scratch_words"]:
        scratch = torch.empty(plan["scratch_words"], dtype=torch.int32, device=dev)
    mask = scratch if plan["words"] else None
    group = scratch[Bn * plan["words"]:] if plan["group_tiles"] else None
    recs = None
    if plan["reduce"]:
        recs = scratch[scratch.numel() - Bn * plan["chunks"] * _BP_RECORD_WORDS[dt.itemsize]:]
    # p and min_e: rows 0 and 1 in float32; in float64 min_e's doubles in
    # rows 0-1 (8-byte aligned), p in row 2
    wd = dt.itemsize // 4
    out = torch.empty((1 + wd, Bn), dtype=torch.int32, device=dev)
    p_out, min_out = (out[0], out[1]) if wd == 1 else (out[wd], out[:wd].reshape(-1))
    spans.mark("launch:batch_pricing")
    err = lib.simplex_batch_pricing(
        _BP_LAYOUTS[plan["layout"]], _A_CODE[A.dtype], _DTYPE_CODE[dt], y.data_ptr(),
        A.data_ptr(), c.data_ptr(), None if at_upper is None else at_upper.data_ptr(),
        basis.data_ptr(), use_bland.data_ptr(), Bn, m, n, int(c.dim() == 1), eps,
        plan["chunks"], plan["words"], None if mask is None else mask.data_ptr(),
        None if recs is None else recs.data_ptr(), p_out.data_ptr(), min_out.data_ptr(),
        w, S, None if window is None else seg.data_ptr(), int(window is not None and A.dim() == 2),
        None if group is None else group.data_ptr(), plan["group_tiles"], _stream(dev),
    )
    _build.check(err, "batch_pricing")
    launches["batch_pricing"] += 1
    return p_out, min_out.view(dt)


_BSCAL, _BFLAGS = 6, 4  # csrc/batch_tail.cu: the scalar rows, the flag rows
# csrc/batch_tail.cu: the warp path's largest m (8 rows a lane) and its
# instances a block; the block path's threads a block at most
_TAIL_WARP_MAX_M = 256
_TAIL_WARPS = 4
_TAIL_BLOCK_THREADS = 512


def batch_tail_plan(Bn: int, m: int, align: int, elem: int = 4) -> dict:
    """How :func:`pivot_tail_batched` launches ``csrc/batch_tail.cu`` for B
    = ``Bn`` instances of m rows of ``elem``-byte floats (4 or 8), every
    pointer aligned to ``align`` bytes: ``path`` "warp" (m <=
    ``_TAIL_WARP_MAX_M``: one warp an instance, ``rows_per_lane`` in 1, 2,
    4, 8, ``vec`` rows a load, 1 or min(rows_per_lane, 4) where m and the
    alignment allow: vec floats in pieces of at most 16 bytes, vec int32 of
    the basis) or "block" (one block of ``threads``, a row a thread up to
    512, an instance); ``blocks`` of the launch."""
    if m <= _TAIL_WARP_MAX_M:
        rpl = 1
        while 32 * rpl < m:
            rpl *= 2
        v = min(rpl, 4)
        need = max(4 * v, min(16, elem * v))
        vec = v if v > 1 and m % v == 0 and align >= need else 1
        return dict(path="warp", rows_per_lane=rpl, vec=vec, threads=32 * _TAIL_WARPS,
                    blocks=-(-Bn // _TAIL_WARPS))
    return dict(path="block", rows_per_lane=0, vec=1,
                threads=min(_TAIL_BLOCK_THREADS, -(-m // 32) * 32), blocks=Bn)


def pivot_tail_batched_plain(*args, **kw) -> PivotTail:
    """The torch composition the batched tail kernel replaces
    (:func:`simplex_tpu_torch.kernels.ops.pivot_tail_batched`)."""
    return _ops.pivot_tail_batched(*args, **kw)


def pivot_tail_batched(
    x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen, status, active, *,
    eps: float, pivot_tol: float, feas_tol: float, harris: bool,
    degen_tol: float, bland_after: int,
    U: Optional[torch.Tensor] = None, R: Optional[torch.Tensor] = None,
    npend: Optional[torch.Tensor] = None,
) -> PivotTail:
    """Every active instance's pivot tail in ONE launch of
    ``csrc/batch_tail.cu`` (one warp an instance up to 256 rows, one block
    beyond: :func:`batch_tail_plan`); the contract of
    :func:`simplex_tpu_torch.kernels.ops.pivot_tail_batched`, bit for bit.
    Every float operand in one dtype, float32 or float64: vectors (B, m)
    (basis int32), B_inv (B, m, m), contiguous; min_e, e_p, c_p (B,); p,
    iters, degen, status (B,) int32; active (B,) bool. Deferred: U, R (B, L,
    m) and npend (B,) int32 (each below L), the new pairs written in place.
    Three allocations: the vector block, the int32 scalars ((6, B); in
    float64 two rows more, which hold theta_q as (B,) doubles) and the (4,
    B) flags."""
    if x_b.dim() != 2 or 0 in x_b.shape:
        raise ValueError(f"x_b: want a non-empty (B, m) stack, got {tuple(x_b.shape)}")
    Bn, m = x_b.shape
    dt = _working_dtype(x_b, "x_b")
    for name, t in (("x_b", x_b), ("alpha", alpha), ("y", y), ("c_b", c_b)):
        _batched(t, (Bn, m), dt, name)
    _batched(basis, (Bn, m), torch.int32, "basis")
    _batched(B_inv, (Bn, m, m), dt, "B_inv")
    for name, t in (("min_e", min_e), ("e_p", e_p), ("c_p", c_p)):
        _batched(t, (Bn,), dt, name)
    for name, t in (("p", p), ("iters", iters), ("degen", degen), ("status", status)):
        _batched(t, (Bn,), torch.int32, name)
    _batched(active, (Bn,), torch.bool, "active")
    ins = [x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen, status, active]
    defer = U is not None
    if (R is not None) != defer or (npend is not None) != defer:
        raise ValueError("U, R and npend go together")
    L = 0
    if defer:
        L = U.shape[1] if U.dim() == 3 else -1
        _batched(U, (Bn, L, m), dt, "U")
        _batched(R, (Bn, L, m), dt, "R")
        _batched(npend, (Bn,), torch.int32, "npend")
        ins += [U, R, npend]
    kw = dict(eps=eps, pivot_tol=pivot_tol, feas_tol=feas_tol, harris=harris,
              degen_tol=degen_tol, bland_after=bland_after, U=U, R=R, npend=npend)
    dev = _same_device(*ins)
    if dev.type == "cpu":
        return pivot_tail_batched_plain(
            x_b, alpha, basis, y, c_b, B_inv, min_e, e_p, c_p, p, iters, degen, status,
            active, **kw,
        )
    lib = _build.load_library()
    vecs = torch.empty((6, Bn, m), dtype=dt, device=dev).unbind(0)
    # the int32 scalars; theta_q in row 1 (float32), or as doubles in the
    # two rows past the six (8-byte aligned: 24 B bytes in)
    w = dt.itemsize // 4
    scal = torch.empty((_BSCAL + (w if w > 1 else 0), Bn), dtype=torch.int32, device=dev)
    theta = (scal[1] if w == 1 else scal[_BSCAL:].reshape(-1)).view(dt)
    flags = torch.empty((_BFLAGS, Bn), dtype=torch.bool, device=dev)
    basis_out = vecs[5].reshape(-1).view(torch.int32)[: Bn * m].view(Bn, m)
    plan = batch_tail_plan(
        Bn, m, _alignment(x_b, alpha, basis, y, c_b, B_inv, *vecs, *((U, R) if defer else ())),
        dt.itemsize)
    st = SolveStatus
    spans.mark("launch:batch_tail")
    err = lib.simplex_batch_tail(
        _DTYPE_CODE[dt], x_b.data_ptr(), alpha.data_ptr(), basis.data_ptr(), y.data_ptr(),
        c_b.data_ptr(),
        B_inv.data_ptr(), U.data_ptr() if defer else None, R.data_ptr() if defer else None,
        npend.data_ptr() if defer else None, L, min_e.data_ptr(), e_p.data_ptr(),
        c_p.data_ptr(), p.data_ptr(), iters.data_ptr(), degen.data_ptr(),
        status.data_ptr(), active.data_ptr(), Bn, m, eps, pivot_tol, feas_tol, degen_tol,
        int(bool(harris)), int(bland_after), int(st.RUNNING), int(st.OPTIMAL),
        int(st.UNBOUNDED), int(st.SINGULAR), plan["threads"], plan["rows_per_lane"],
        plan["vec"], vecs[0].data_ptr(),
        vecs[1].data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(), vecs[4].data_ptr(),
        basis_out.data_ptr(), scal.data_ptr(), theta.data_ptr(), flags.data_ptr(), _stream(dev),
    )
    _build.check(err, "batch_tail")
    launches["batch_tail"] += 1
    q, _, it, status_o, dg, np_o = scal[:_BSCAL].unbind(0)
    optimal, unbounded, bad, take = flags.unbind(0)
    return PivotTail(
        x_b=vecs[2], y=vecs[3], c_b=vecs[4], basis=basis_out, iters=it, status=status_o,
        degen=dg, npend=np_o if defer else None, eta=vecs[0], row=vecs[1], q=q,
        theta_q=theta, optimal=optimal, unbounded=unbounded, bad=bad,
        take=take,
    )


def rank1_update_batched_plain(B_inv, eta, row, take) -> torch.Tensor:
    """``B_inv[i] += eta[i] (x) row[i]`` where ``take[i]``, in place
    (:func:`simplex_tpu_torch.kernels.ops.rank1_update_batched`)."""
    return _ops.rank1_update_batched(B_inv, eta, row, take)


def rank1_update_batched(
    B_inv: torch.Tensor, eta: torch.Tensor, row: torch.Tensor, take: torch.Tensor
) -> torch.Tensor:
    """``B_inv[i] += eta[i] (x) row[i]`` IN PLACE for every instance with
    ``take[i]`` (read on the device), in one launch of
    ``csrc/batch_rank1.cu``; the others untouched. B_inv (B, m, m)
    contiguous; eta, row (B, m) contiguous, not overlapping B_inv; all three
    float32 or all three float64; take (B,) bool. Equal to the plain version
    bit for bit."""
    _require(
        B_inv.dim() == 3 and B_inv.shape[1] == B_inv.shape[2] and B_inv.numel() > 0,
        f"B_inv: want a non-empty (B, m, m) stack, got {tuple(B_inv.shape)}",
    )
    Bn, m, _ = B_inv.shape
    dt = _working_dtype(B_inv, "B_inv")
    _batched(B_inv, (Bn, m, m), dt, "B_inv")
    _batched(eta, (Bn, m), dt, "eta")
    _batched(row, (Bn, m), dt, "row")
    _batched(take, (Bn,), torch.bool, "take")
    dev = _same_device(B_inv, eta, row, take)
    _require(
        not _overlaps(row, B_inv) and not _overlaps(eta, B_inv),
        "rank1_update_batched: eta / row overlap B_inv (pass copies of the rows)",
    )
    if dev.type == "cpu":
        return rank1_update_batched_plain(B_inv, eta, row, take)
    _require(Bn <= _BATCH_GRID_MAX, f"batch_rank1: at most {_BATCH_GRID_MAX} instances")
    lib = _build.load_library()
    vec = m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (B_inv, row))
    spans.mark("launch:batch_rank1")
    err = lib.simplex_batch_rank1(
        _DTYPE_CODE[dt], B_inv.data_ptr(), eta.data_ptr(), row.data_ptr(), take.data_ptr(), Bn, m,
        int(vec), _stream(dev),
    )
    _build.check(err, "batch_rank1")
    launches["batch_rank1"] += 1
    return B_inv
