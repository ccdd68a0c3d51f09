"""The level-scheduled Gauss-Seidel sweep as a hand-written CUDA kernel,
and its plain torch version.

The JAX package has no Pallas kernel for the sweep: it runs one
`lax.scan` step per wavefront, a gather, a row sum and a scatter-add
(hypre_tpu/solvers/amg/relax.py::gauss_seidel, :174-193), which XLA
compiles into one loop on the TPU.  Eager torch would pay about six
launches a wavefront (some 5,400 wavefronts a 96^3 V-cycle), so the port
runs a whole sweep of a level as one launch of `csrc/gs_sweep.cu`.

`gs_sweep_cuda` takes a schedule (solvers/amg/relax.py::GSSchedule: the
level's CSR, inverse divisor and sweep state, the rows in wavefront
order, each row's wavefront, the wavefront pointers and hazard flags,
all on the card) and float64 or float32 vectors; it builds the kernel
with nvcc for sm_90a at first use (into `hypre_tpu_torch/_build/`, bound
with ctypes) and raises on any input it does not take.  It has two
forms with the same per-row arithmetic, so the same bits:

* "syncfree" (the default): no wavefront barrier; each row polls the
  values the rows it reads new publish with their sweep's epoch (row i
  reads u_j new iff 0 <= wave[j] < wave[i]), in one cooperative grid.
* "wavefront" (the reference form): the wavefronts in order with a
  barrier between them, in one block (`ONE_BLOCK_MAX_ROWS`) or a
  cooperative grid (`coop=`).

Each launch adds one to `gs_sweep_cuda.launches`, and a sync-free one
also to `gs_sweep_cuda.syncfree_launches`.  A sync-free wait that gives
up writes the device's fault word (`fault_word`), which callers read
after a synchronize (`read_fault`); a failed build or a refused launch
raises.  Nothing falls back to the other form or to the plain version.

`gs_sweep_reference` is the JAX step in torch, over the JAX package's
padded `[L, W, width]` slabs (GSSchedule.slabs): the same dtypes and the
same order of operations a wavefront.  It runs on any device; the CPU
path uses it, and chip_smoke.py holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda

_VEC = {torch.float64: "f64", torch.float32: "f32"}
FORMS = ("syncfree", "wavefront")
# The form the wrapper takes when none is asked for: the sync-free one on
# every level (`lane_sweep --gs` at 96^3 on the H100, 700 W: faster than
# the wavefront form's better variant on each of the 14 schedules, from
# level 6's 18 us against 21 to level 1's 475 against 1,649).
DEFAULT_FORM = "syncfree"

# (indptr, indices, data, dinv, order, wf_ptr, hazard, f, v, u, scratch,
#  w, omega, omega_form, nwf, max_width, lanes, coop, stream)
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_double, ctypes.c_double]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# (indptr, indices, data, dinv, slots, wave, f, v, u, out, done, ctl,
#  fault, w, omega, omega_form, nslots, lanes, max_blocks, stream)
_FREE_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_double, ctypes.c_double]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# (buf, rounds, mode, res, stream)
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
STEP_MODES = {"flag": 0, "published": 1}

# The wavefront form: a level whose widest wavefront has at most this
# many rows sweeps in one block (__syncthreads between wavefronts); a
# wider one in a cooperative grid (a grid sync between wavefronts).
# Measured on the H100 (700 W) at the 96^3 levels with `python -m
# hypre_tpu_torch.lane_sweep --gs`: level 2's 95-row wavefronts sweep in
# 1.95 ms in one block (16 lanes) against 2.18 ms at best in the grid,
# level 1's 668-row ones in 1.65 ms in the grid against 4.17 ms at best
# in one block.
ONE_BLOCK_MAX_ROWS = 128
_BLOCK_THREADS = 1024  # the one-block form's threads (csrc/gs_sweep.cu)


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    types = {f"gs_sweep_{dt}": _ARGTYPES for dt in _VEC.values()}
    types.update({f"gs_syncfree_{dt}": _FREE_ARGTYPES for dt in _VEC.values()})
    types["gs_step_probe"] = _PROBE_ARGTYPES
    return load_cuda("gs_sweep", types)


_FAULTS: dict = {}


def fault_word(device) -> torch.Tensor:
    """The device's fault word (int32 [1], 0 until a sync-free wait gives
    up; then 1 + the slot of the first row that did)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _FAULTS:
        _FAULTS[idx] = torch.zeros(1, dtype=torch.int32,
                                   device=torch.device("cuda", idx))
    return _FAULTS[idx]


def read_fault(device) -> int:
    """The fault word's value (synchronizes with the device)."""
    return int(fault_word(device).item())


def clear_fault(device) -> None:
    fault_word(device).zero_()


def row_lanes(max_row: int, max_width: int, one_block: bool) -> int:
    """S, the lanes that share a row (1..32): enough that a lane sums at
    most two entries of the longest row; in the one-block form no more
    than two passes of the block over the widest wavefront allow
    (`lane_sweep --gs` at 96^3 on the H100: level 0 sweeps in the grid
    in 0.88 ms with 4 lanes against 0.97 with 2, level 2 in one block
    in 1.95 ms with 16 against 2.65 with 32)."""
    s = 1
    while s < 32 and 2 * s < max_row:
        s *= 2
    while one_block and s > 1 and s * max_width > 2 * _BLOCK_THREADS:
        s //= 2
    return s


def free_lanes(max_row: int) -> int:
    """S for the sync-free form: a lane for each entry of the longest row,
    up to 32.  `lane_sweep --gs` at 96^3 on the H100 (700 W): level 0's
    7-entry rows sweep in 422 us with 8 lanes against 447 with 4 and 544
    with 16, levels 1-5 (24-109 entries) fastest with 32 (level 1 in 478
    us against 560 with 16)."""
    s = 1
    while s < 32 and s < max_row:
        s *= 2
    return s


def _check(sched, u, f, v, plain):
    n = sched.n
    m = sched.mat
    if u.device.type != "cuda":
        raise ValueError(f"gs_sweep_cuda needs CUDA tensors, got {u.device}")
    dt = _VEC.get(u.dtype)
    if dt is None:
        raise TypeError(f"gs_sweep_cuda: unsupported vector dtype {u.dtype}")
    vecs = (u, f) if plain else (u, f, v)
    for t in vecs:
        if t.dtype != u.dtype or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"gs_sweep_cuda: vectors must be contiguous "
                             f"{u.dtype} [{n}]")
    ints = (m.indptr, m.indices, sched.order, sched.wf_ptr, sched.wave,
            sched.slots, m.ctl)
    tensors = (*vecs, *ints, m.data, m.dinv, m.done, sched.hazard)
    if any(t.device != u.device for t in tensors):
        raise ValueError("gs_sweep_cuda: every tensor must be on u's "
                         f"device, {u.device}")
    if (any(t.dtype != torch.int32 for t in ints)
            or m.data.dtype != torch.float64 or m.dinv.dtype != torch.float64
            or m.done.dtype != torch.int64 or sched.hazard.dtype != torch.uint8):
        raise TypeError("gs_sweep_cuda: int32 indices, float64 data and "
                        "dinv, int64 done words, uint8 hazard flags")
    if (m.indptr.shape != (n + 1,) or m.dinv.shape != (n,)
            or sched.wave.shape != (n,) or m.done.shape != (n, 2)
            or not m.done.is_contiguous()):
        raise ValueError(f"gs_sweep_cuda: indptr [{n + 1}], dinv and wave "
                         f"[{n}], done contiguous [{n}, 2]")
    return dt


def gs_sweep_cuda(sched, u: torch.Tensor, f: torch.Tensor,
                  weight: float = 1.0, omega: float = 1.0, v=None, *,
                  form: str | None = None, coop: bool | None = None,
                  lanes: int | None = None, blocks: int = 0) -> torch.Tensor:
    """One sweep of `sched` on the card, one launch; returns the new u
    (u itself is not changed).  omega == 1 takes the plain form and
    ignores v; otherwise v (the iterate before the relaxation call,
    default u) enters S_pre.  `form` is "syncfree" or "wavefront"
    (default: `DEFAULT_FORM`); `lanes` the lanes a row; for the
    wavefront form `coop` forces the grid (True) or the one-block (False)
    form; for the sync-free form `blocks` caps the grid (0: as many
    blocks as can be resident, the default)."""
    plain = float(omega) == 1.0
    if not plain and v is None:
        v = u
    dt = _check(sched, u, f, v, plain)
    form = DEFAULT_FORM if form is None else form
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if form == "syncfree" and coop is not None:
        raise ValueError("coop= picks a wavefront form's grid")
    if form == "wavefront" and coop is None:
        coop = sched.max_width > ONE_BLOCK_MAX_ROWS
    if lanes is None:
        lanes = (free_lanes(sched.max_row) if form == "syncfree" else
                 row_lanes(sched.max_row, sched.max_width, not coop))
    elif lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be 1, 2, 4, 8, 16 or 32, got {lanes}")
    lib, _ = load()
    m = sched.mat
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "syncfree":
            # every row of a full schedule is written: no copy of u
            out = torch.empty_like(u) if sched.full else u.clone()
            rc = getattr(lib, f"gs_syncfree_{dt}")(
                m.indptr.data_ptr(), m.indices.data_ptr(), m.data.data_ptr(),
                m.dinv.data_ptr(), sched.slots.data_ptr(),
                sched.wave.data_ptr(), f.data_ptr(),
                None if plain else v.data_ptr(), u.data_ptr(), out.data_ptr(),
                m.done.data_ptr(), m.ctl.data_ptr(),
                fault_word(u.device).data_ptr(), float(weight), float(omega),
                0 if plain else 1, sched.slots.numel(), lanes, int(blocks),
                stream)
            what = "sync-free grid"
        else:
            out = u.clone()
            scratch = (torch.empty(sched.order.numel(), dtype=torch.float64,
                                   device=u.device)
                       if sched.any_hazard else None)
            rc = getattr(lib, f"gs_sweep_{dt}")(
                m.indptr.data_ptr(), m.indices.data_ptr(), m.data.data_ptr(),
                m.dinv.data_ptr(), sched.order.data_ptr(),
                sched.wf_ptr.data_ptr(), sched.hazard.data_ptr(),
                f.data_ptr(), None if plain else v.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                float(weight), float(omega), 0 if plain else 1,
                sched.num_wavefronts, sched.max_width, lanes,
                1 if coop else 0, stream)
            what = "cooperative grid" if coop else "one block"
    if rc != 0:
        raise RuntimeError(f"gs_sweep kernel launch failed: CUDA error {rc} "
                           f"({what})")
    gs_sweep_cuda.launches += 1
    if form == "syncfree":
        gs_sweep_cuda.syncfree_launches += 1
    return out


gs_sweep_cuda.launches = 0
gs_sweep_cuda.syncfree_launches = 0


def step_probe(device, rounds: int = 20000, mode: str = "published") -> dict:
    """t_step, one cross-SM step, by two warps on two SMs passing a value
    back and forth `rounds` times.  "published" is the sync-free
    kernel's step: publish the value with its epoch in 64-bit words, the
    other polls them (relaxed, through L2).  "flag" is the design it
    replaced: store the value and release an int32 flag, the other polls
    the flag with acquire loads and then loads the value through L2.
    Returns {"ns": ns a step, "sms": the two SMs}; raises if a value
    arrived wrong or a poll gave up."""
    dev = torch.device(device)
    lib, _ = load()
    buf = torch.zeros(8, dtype=torch.int64, device=dev)  # 64 bytes
    res = torch.zeros(4, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gs_step_probe(buf.data_ptr(), int(rounds), STEP_MODES[mode],
                               res.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gs_step_probe launch failed: CUDA error {rc}")
    ns, bad, sm0, sm1 = (int(x) for x in res.cpu())
    if bad or sm0 == sm1:
        raise RuntimeError(f"gs_step_probe: {bad} bad steps, SMs {sm0} / {sm1}")
    return {"ns": ns / (2 * rounds), "sms": (sm0, sm1)}


def gs_sweep_reference(slabs, n: int, u: torch.Tensor, f: torch.Tensor,
                       weight: float = 1.0, omega: float = 1.0,
                       v=None) -> torch.Tensor:
    """The JAX step (relax.py:174-193) in torch over the padded slabs
    (rows [L, W] with the sentinel n, acols / adata [L, W, width], dinv
    [L, W], on u's device): each wavefront gathers u, sums its rows in
    the slabs' float64 and adds the update, rounded to u's dtype, to
    every row of the wavefront at once."""
    rows, acols, adata, dinv = slabs
    u_ext = torch.cat([u, u.new_zeros(1)])
    f_ext = torch.cat([f, f.new_zeros(1)])
    plain = float(omega) == 1.0
    if not plain:
        # the pre-sweep iterate, kept apart from the u updated in place
        v_ext = (u_ext.clone() if v is None
                 else torch.cat([v, v.new_zeros(1)]))
    for l in range(rows.shape[0]):
        r_l, c_l, a_l, d_l = rows[l], acols[l], adata[l], dinv[l]
        if plain:
            r = f_ext[r_l] - torch.sum(a_l * u_ext[c_l], dim=-1)
            u_ext.index_add_(0, r_l, (weight * d_l * r).to(u.dtype))
        else:
            s_cur = torch.sum(a_l * u_ext[c_l], dim=-1)
            s_pre = torch.sum(a_l * v_ext[c_l], dim=-1)
            r = omega * f_ext[r_l] - s_cur + (1.0 - omega) * s_pre
            upd = weight * ((1.0 - omega) * (u_ext[r_l] - v_ext[r_l])
                            + d_l * r)
            # zero-divisor rows (and the pads) are skipped
            u_ext.index_add_(
                0, r_l, torch.where(d_l != 0, upd, 0.0).to(u.dtype))
    return u_ext[:n]
