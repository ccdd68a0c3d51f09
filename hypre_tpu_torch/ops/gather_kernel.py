"""The TPU gather probes K2/K3 (scripts/exp_mosaic_gather.py) as
hand-written CUDA kernels, their launch plans and their plain torch
versions.

    take_along_axis_cuda(x, idx, axis)  out[r, c] = x[r mod R, idx[r, c]] (axis 1)
                                        out[r, c] = x[idx[r, c], c mod C] (axis 0)
    flat_take_cuda(table, idx)          out = table[idx]

x is [R, C]; along axis 1 idx's rows are a multiple of R (K3 gathers
8 blocks of 512 rows from one resident [512, 512] x block), along
axis 0 idx's columns are a multiple of C.  With idx the shape of x this
is `np.take_along_axis`.  Values are f32 (flat_take: f32 or f64), indices
int32 in range.

`take_along_axis_cuda` and `flat_take_cuda` launch `csrc/gather.cu`
(nvcc, sm_90a, ctypes, built at first use into `hypre_tpu_torch/_build/`)
and count their launches; a CPU tensor is refused.  Each has two forms,
the same bits: "tiled" (`DEFAULT_FORM`), whose geometry `take_plan` /
`flat_plan` give (take_along_axis: the block owns a part of x staged in
shared memory, or read through L2 when that part is too large, and walks
16-byte quads of idx and out; flat_take: one element a thread on a full
grid, 32-bit), and "elementwise", the earlier one element a thread,
kept as the reference.  Nothing falls back from one to the other.

Their plain versions run on any device: `take_along_axis_reference`
(`torch.take_along_dim`) and `flat_take_reference` (`torch.index_select`)
are what the CPU path runs and what chip_smoke.py holds the kernels
against on the card; `take_along_axis_tiled` and `flat_take_tiled`
compute the result block by block as the plans assign it, so the CPU
tests show that a plan writes every output element exactly once.
`flat_take` is the solver's entry: GatherOp's x[pos] (ops/dia.py) goes
through it, to the kernel for a CUDA tensor and to the plain version for
a CPU tensor, but for the gather of a dense operator on cells (the
collapsed coarse solve), which runs inside the cell_dense kernel.  The
take_along_axis gathers are on no solver path.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..native import load_cuda

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    # (x, idx, out, x rows, x cols, idx rows, idx cols, axis, shared,
    #  batch, grid x, grid y, group, span, chunk, quads, threads, smem
    #  bytes, vec, stream)
    "take_along_axis_f32": [_P] * 3 + [_I64] * 4 + [_INT] * 2 + [_I64] * 9
    + [_INT, _P],
    # (table, idx, out, count, blocks, threads, stream)
    "flat_take_f32": [_P] * 3 + [_I64] * 3 + [_P],
    "flat_take_f64": [_P] * 3 + [_I64] * 3 + [_P],
    # the elementwise form: (x, idx, out, x rows, x cols, idx rows, idx
    # cols, axis, stream) and (table, idx, out, count, stream)
    "take_along_axis_elementwise_f32": [_P] * 3 + [_I64] * 4 + [_INT, _P],
    "flat_take_elementwise_f32": [_P] * 3 + [_I64, _P],
    "flat_take_elementwise_f64": [_P] * 3 + [_I64, _P],
}
_FLAT_TAKE = {torch.float32: "f32", torch.float64: "f64"}

FORMS = ("tiled", "elementwise")
DEFAULT_FORM = "tiled"

# The card (H100 SXM): its SMs, and the shared memory a block may take
SMS = 132
MAX_SHARED_BYTES = 232_448
INT32_MAX = 2**31 - 1
# csrc/gather.cu's constants: threads a block (at most) and the quads a
# take_along_axis thread has in flight when it has more than one
TAKE_THREADS, TAKE_BATCH = 128, 8
FLAT_THREADS = 256
STRIP = 32  # columns of x a block stages along axis 0
# a group's segments spread over blocks until the grid has this many
TARGET_BLOCKS = 2 * SMS


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("gather", _ARGTYPES)


def _check(name: str, src: torch.Tensor, idx: torch.Tensor,
           dtypes=(torch.float32,)) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {src.device}")
    if idx.device != src.device:
        raise ValueError(f"device mismatch: {src.device}, idx {idx.device}")
    if src.dtype not in dtypes or idx.dtype != torch.int32:
        raise TypeError(f"{name}: needs values in {dtypes} and int32 "
                        f"indices, got {src.dtype} and {idx.dtype}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")


def _shapes(x_shape, idx_shape, axis: int):
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if len(x_shape) != 2 or len(idx_shape) != 2:
        raise ValueError("take_along_axis needs 2-D x and idx")
    (xr, xc), (ir, ic) = x_shape, idx_shape
    other_x, other_i = (xr, ir) if axis == 1 else (xc, ic)
    if other_x == 0 or other_i % other_x:
        raise ValueError(
            f"idx {tuple(idx_shape)} does not tile x {tuple(x_shape)} "
            f"across axis {1 - axis}")
    return xr, xc, ir, ic


def _form(form, plan):
    form = DEFAULT_FORM if form is None else form
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if plan is not None and form != "tiled":
        raise ValueError("a plan is for the tiled form")
    return form


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TakePlan:
    """One tiled take_along_axis launch.  Block (g, b) of the grid owns
    group g of x (`group` rows along axis 1, a strip of `group` columns
    along axis 0; the last may be narrower) and walks the group's
    segments [b * chunk, (b + 1) * chunk) with `threads` threads, each
    with `batch` quads in flight.  A segment is a contiguous run of out
    that reads only its group: a piece of `span` elements of an idx row
    (axis 1; the group's segments ordered by the x row s, then the idx
    row t * xr + s, then the piece), or the strip's columns of one column
    tile of an idx row (axis 0; r outer).  A segment spans at most
    `quads` 4-element quads, counted from the 16-byte boundary below its
    start."""
    axis: int
    instance: str  # "shared": the group staged in shared memory; "l2"
    shape: tuple  # (x rows, x cols, idx rows, idx cols)
    reps: int  # idx rows a row of x serves (axis 1), column tiles (axis 0)
    group: int
    span: int  # axis 1: a segment's elements; axis 0: the strip's width
    grid: tuple  # (groups, blocks a group)
    chunk: int
    quads: int
    threads: int
    batch: int  # 1 or TAKE_BATCH
    smem: int  # bytes a block


def _spread(gx: int, nseg: int, quads: int) -> int:
    """Blocks a group: its segments spread until the grid has
    TARGET_BLOCKS, each block keeping at least a quad for each thread."""
    return max(1, min(_cdiv(TARGET_BLOCKS, gx),
                      nseg * quads // TAKE_THREADS, nseg))


def take_plan(x_shape, idx_shape, axis: int, *, instance: str | None = None,
              span: int | None = None, spread: int | None = None,
              threads: int | None = None,
              batch: int | None = None) -> TakePlan:
    """The tiled form's launch for x [xr, xc] and idx [ir, ic] along
    `axis`.  Refuses (ValueError) what `_shapes` refuses, and an output or
    an x of 2^31 elements or more (the kernel indexes in 32 bits).  The
    keywords override the plan's choices (lane_sweep.py --gathers times
    them): `instance`, `span` (axis 1: the elements of an idx row a
    segment takes, a multiple of 4 below ic), `spread` (blocks a group),
    `threads` (a multiple of 32 up to TAKE_THREADS) and `batch` (1 or
    TAKE_BATCH; the plan takes 1, the instance without the unrolled batch,
    where no thread has more than one quad: a short run's time is its
    latencies, and the kernel's code is among them when it comes from
    memory, as after the timing method's L2 flush)."""
    xr, xc, ir, ic = _shapes(tuple(x_shape), tuple(idx_shape), axis)
    if ir * ic > INT32_MAX or xr * xc > INT32_MAX:
        raise ValueError(
            f"take_along_axis: x {(xr, xc)} or out {(ir, ic)} has 2^31 "
            f"elements or more; the tiled kernel indexes in 32 bits")
    if axis == 1:
        reps, part = ir // xr, 4 * xc  # part: the bytes of a row of x
        span = max(ic, 1) if span is None or span >= ic else span
        if span < 1 or (span < ic and span % 4):
            raise ValueError(f"take_along_axis: span {span} must be a "
                             f"multiple of 4 below ic {ic}")
        pieces = _cdiv(ic, span) if ic else 1
        quads = _cdiv(span, 4) + (0 if ic % 4 == 0 else 1)
        # a few rows of x a block where an x row's segments are short,
        # while the grid keeps TARGET_BLOCKS groups and 48 KB a block
        group = max(1, min(TAKE_THREADS // max(1, reps * pieces * quads),
                           xr // TARGET_BLOCKS, 48 * 1024 // max(part, 1)))
    else:
        reps, span = ic // xc, min(STRIP, xc)
        quads = _cdiv(span, 4) + (0 if ic % 4 == 0 and xc % 4 == 0 else 1)
        group, part = span, 4 * xr * span  # part: the bytes of a strip
    instance = instance or ("shared" if part <= MAX_SHARED_BYTES else "l2")
    if instance not in ("shared", "l2") or (
            instance == "shared" and part > MAX_SHARED_BYTES):
        raise ValueError(f"take_along_axis: no {instance!r} instance for "
                         f"{part} bytes of x a block")
    if instance == "l2":
        group = 1 if axis == 1 else group
    smem = group * part if axis == 1 else part
    smem = smem if instance == "shared" else 0
    gx = _cdiv(xr, group) if axis == 1 else _cdiv(xc, group)
    nseg = reps * group * pieces if axis == 1 else ir * reps
    if spread is not None and spread < 1:
        raise ValueError(f"take_along_axis: spread {spread}")
    gy = spread or _spread(gx, nseg, quads)
    chunk = _cdiv(nseg, min(gy, nseg)) if nseg else 0
    gy = _cdiv(nseg, chunk) if nseg else 0
    threads = threads or min(TAKE_THREADS, 32 * max(1, _cdiv(chunk * quads, 32)))
    if threads % 32 or not 0 < threads <= TAKE_THREADS:
        raise ValueError(f"take_along_axis: {threads} threads a block")
    if chunk * quads + threads * TAKE_BATCH > INT32_MAX:
        raise ValueError(f"take_along_axis: a block's {chunk} segments of "
                         f"{quads} quads overflow 32-bit counting")
    batch = batch or (1 if chunk * quads <= threads else TAKE_BATCH)
    if batch not in (1, TAKE_BATCH):
        raise ValueError(f"take_along_axis: batch {batch}, not 1 or "
                         f"{TAKE_BATCH}")
    return TakePlan(axis, instance, (xr, xc, ir, ic), reps, group, span,
                    (gx, gy) if ir * ic else (0, 0), chunk, quads, threads,
                    batch, smem)


@dataclasses.dataclass(frozen=True)
class FlatPlan:
    """One tiled flat_take launch: `blocks` of `threads`; thread t of the
    grid takes the elements t, t + blocks * threads, ..."""
    total: int
    blocks: int
    threads: int


def flat_plan(total: int, *, threads: int | None = None,
              blocks: int | None = None) -> FlatPlan:
    """The tiled flat_take launch for `total` gathers: a thread for each
    element.  A gather from a table is bound by its scattered reads (the
    card's L2 sector rate at 2M gathers from a 512 KB table) or, at the
    probe's 32,768 and the lattice path's 1,529-1,731, by the launch and
    two memory latencies, not by the instructions a gather takes.
    Refuses 2^31 or more (32-bit indexing).  `threads` (a multiple of 32
    up to FLAT_THREADS) and `blocks` (fewer: a thread walks several
    elements) override the plan's; lane_sweep.py --gathers times them."""
    if total > INT32_MAX:
        raise ValueError(f"flat_take: {total} gathers, 2^31 or more; the "
                         f"tiled kernel indexes in 32 bits")
    threads = threads or FLAT_THREADS
    if threads % 32 or not 0 < threads <= FLAT_THREADS:
        raise ValueError(f"flat_take: {threads} threads a block")
    blocks = _cdiv(total, threads) if blocks is None else blocks
    if total and not 0 < blocks <= INT32_MAX:
        raise ValueError(f"flat_take: {blocks} blocks")
    return FlatPlan(total, blocks, threads)


def _take_plan_for(plan, x, idx, axis) -> TakePlan:
    """`plan`, or `take_plan`'s when None; a plan for other shapes is
    refused."""
    if plan is None:
        return take_plan(x.shape, idx.shape, axis)
    if plan.shape != (*x.shape, *idx.shape) or plan.axis != axis:
        raise ValueError(f"take_along_axis: the plan is for {plan.shape} "
                         f"along axis {plan.axis}")
    return plan


def _flat_plan_for(plan, idx) -> FlatPlan:
    """`plan`, or `flat_plan`'s when None; a plan for another count is
    refused."""
    if plan is None:
        return flat_plan(idx.numel())
    if plan.total != idx.numel():
        raise ValueError(f"flat_take: the plan is for {plan.total} gathers")
    return plan


def _launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _vec(*tensors) -> int:
    """1 when every pointer is 16-byte aligned (the tiled kernels' 16-byte
    accesses), else 0 (they move scalars)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def take_along_axis_cuda(x: torch.Tensor, idx: torch.Tensor, axis: int,
                         form: str | None = None,
                         plan: TakePlan | None = None) -> torch.Tensor:
    """take_along_axis on the card (K2 (a)/(b), K3), one launch of the
    `form` asked for (default `DEFAULT_FORM`); the tiled form launches
    `plan` (default `take_plan`'s)."""
    form = _form(form, plan)
    _check("take_along_axis_cuda", x, idx)
    if form == "tiled":
        plan = _take_plan_for(plan, x, idx, axis)
        xr, xc, ir, ic = plan.shape
    else:
        xr, xc, ir, ic = _shapes(tuple(x.shape), tuple(idx.shape), axis)
    lib, _ = load()
    out = torch.empty(ir, ic, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if form == "tiled":
            rc = lib.take_along_axis_f32(
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), xr, xc, ir, ic,
                axis, int(plan.instance == "shared"), plan.batch, *plan.grid,
                plan.group, plan.span, plan.chunk, plan.quads, plan.threads,
                plan.smem,
                _vec(x, idx, out), stream)
        else:
            rc = lib.take_along_axis_elementwise_f32(
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), xr, xc, ir, ic,
                axis, stream)
    _launch(rc, "take_along_axis")
    take_along_axis_cuda.launches += 1
    return out


take_along_axis_cuda.launches = 0


def flat_take_cuda(table: torch.Tensor, idx: torch.Tensor,
                   form: str | None = None,
                   plan: FlatPlan | None = None) -> torch.Tensor:
    """table[idx] on the card (K2 (c)), one launch of the `form` asked for
    (default `DEFAULT_FORM`; the tiled form launches `plan`, default
    `flat_plan`'s); table is 1-D f32 or f64, idx any shape."""
    form = _form(form, plan)
    _check("flat_take_cuda", table, idx, tuple(_FLAT_TAKE))
    if table.dim() != 1:
        raise ValueError("flat_take needs a 1-D table")
    if form == "tiled":
        plan = _flat_plan_for(plan, idx)
    lib, _ = load()
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    dt = _FLAT_TAKE[table.dtype]
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        if form == "tiled":
            rc = getattr(lib, f"flat_take_{dt}")(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), plan.total,
                plan.blocks, plan.threads, stream)
        else:
            rc = getattr(lib, f"flat_take_elementwise_{dt}")(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                stream)
    _launch(rc, "flat_take")
    flat_take_cuda.launches += 1
    return out


flat_take_cuda.launches = 0


def take_along_axis_reference(x: torch.Tensor, idx: torch.Tensor,
                              axis: int) -> torch.Tensor:
    """Plain torch take_along_axis with x tiled as the kernel reads it."""
    xr, xc, ir, ic = _shapes(tuple(x.shape), tuple(idx.shape), axis)
    idx = idx.long()  # take_along_dim takes int64 indices only
    if axis == 1:
        out = torch.take_along_dim(x.unsqueeze(0),
                                   idx.reshape(ir // xr, xr, ic), dim=2)
    else:
        out = torch.take_along_dim(x.unsqueeze(1),
                                   idx.reshape(ir, ic // xc, xc), dim=0)
    return out.reshape(ir, ic)


def _segments(plan: TakePlan, g: int):
    """(start, key, length) of group g's segments in the kernel's order:
    their first output element, the x row within the group (axis 1; 0
    along axis 0) and their elements."""
    xr, xc, ir, ic = plan.shape
    g0 = g * plan.group
    if plan.axis == 1:
        gn = min(plan.group, xr - g0)
        pieces = _cdiv(ic, plan.span)
        i = torch.arange(plan.reps * gn * pieces)
        kt, piece = i // pieces, i % pieces
        key, t = kt // plan.reps, kt % plan.reps
        return ((t * xr + g0 + key) * ic + piece * plan.span, key,
                torch.clamp(ic - piece * plan.span, max=plan.span))
    gn = min(plan.group, xc - g0)
    i = torch.arange(ir * plan.reps)
    r, t = i // plan.reps, i % plan.reps
    return r * ic + t * xc + g0, torch.zeros_like(i), torch.full_like(i, gn)


def take_along_axis_tiled(x: torch.Tensor, idx: torch.Tensor, axis: int,
                          hits: torch.Tensor | None = None,
                          plan: TakePlan | None = None) -> torch.Tensor:
    """take_along_axis computed block by block as `plan` (default
    `take_plan`'s) assigns it: each block stages its group of x (the
    shared instance) or reads x (the L2 instance) and writes the elements
    of its segments' quads that lie in their segment.  `hits` (int64,
    the output's size), when given, counts each output element's
    writes."""
    plan = _take_plan_for(plan, x, idx, axis)
    xr, xc, ir, ic = plan.shape
    out = torch.empty(ir * ic, dtype=x.dtype, device=x.device)
    xf, jf = x.reshape(-1), idx.reshape(-1).long()
    lane = torch.arange(4)
    gx, gy = plan.grid
    for g in range(gx):
        start, keys, lengths = _segments(plan, g)
        g0 = g * plan.group
        gn = min(plan.group, (xr if axis == 1 else xc) - g0)
        if plan.instance == "shared":  # what the block stages
            xs = (xf[g0 * xc:(g0 + gn) * xc] if axis == 1
                  else x[:, g0:g0 + gn].reshape(-1)).clone()
        for b in range(gy):
            blk = slice(b * plan.chunk, (b + 1) * plan.chunk)
            a, key, length = start[blk], keys[blk], lengths[blk]
            if a.numel() == 0:
                continue
            s = torch.arange(a.numel() * plan.quads) // plan.quads
            q = torch.arange(a.numel() * plan.quads) % plan.quads
            e = (a[s] - a[s] % 4 + 4 * q)[:, None] + lane
            ok = (e >= a[s, None]) & (e < (a + length)[s, None])
            e, pos = e[ok], (e - a[s, None])[ok]
            key = key[s, None].expand(-1, 4)[ok]
            j = jf[e]
            if axis == 1:
                out[e] = (xs[key * xc + j] if plan.instance == "shared"
                          else xf[(g0 + key) * xc + j])
            else:
                out[e] = (xs[j * gn + pos] if plan.instance == "shared"
                          else xf[j * xc + g0 + pos])
            if hits is not None:
                hits.index_add_(0, e, torch.ones_like(e))
    return out.reshape(ir, ic)


def flat_take_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch table[idx]."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(idx.shape)


def flat_take_tiled(table: torch.Tensor, idx: torch.Tensor,
                    hits: torch.Tensor | None = None,
                    plan: FlatPlan | None = None) -> torch.Tensor:
    """table[idx] computed block by block as `plan` (default `flat_plan`'s)
    assigns it: each thread's elements, a grid's stride apart.  `hits`
    as in `take_along_axis_tiled`."""
    plan = _flat_plan_for(plan, idx)
    out = torch.empty(plan.total, dtype=table.dtype, device=table.device)
    jf = idx.reshape(-1).long()
    stride = plan.blocks * plan.threads
    for blk in range(plan.blocks):
        t = blk * plan.threads + torch.arange(plan.threads)
        e = t[None, :] + stride * torch.arange(
            _cdiv(plan.total, stride))[:, None]
        e = e[e < plan.total]
        out[e] = table[jf[e]]
        if hits is not None:
            hits.index_add_(0, e, torch.ones_like(e))
    return out.view(idx.shape)


def flat_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if table.device.type == "cuda":
        return flat_take_cuda(table, idx)
    if table.device.type == "cpu":
        return flat_take_reference(table, idx)
    raise ValueError(f"flat_take: no path for device {table.device}")
