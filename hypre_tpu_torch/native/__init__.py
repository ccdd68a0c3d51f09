"""Native host-setup kernels (ctypes-bound C), the subset the port's
BoomerAMG setup and its ILU factorizations use.

The source is the port's own, `hypre_tpu_torch/csrc/host_kernels.c`: a
copy of the functions of the JAX package's `native/kernels.c` that are
bound here, bodies unchanged, so the port builds without that tree.
This loader compiles it into the port's build directory,
`hypre_tpu_torch/_build/`, at first use.  Unlike the JAX package's
loader there is no Python fallback: a failed build raises with the
compiler's output.

The CSR bindings run the kernels' int32-index variants, on scipy's
int32-index float64 arrays without a copy (`BoomerAMG._setup` converts
the fine matrix once; every product after it stays int32).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import scipy.sparse as sp

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")
_SRC = os.path.join(CSRC_DIR, "host_kernels.c")
_SO = os.path.join(BUILD_DIR, "libhypre_host_kernels.so")

I32 = ctypes.POINTER(ctypes.c_int32)
I64 = ctypes.POINTER(ctypes.c_int64)
F64 = ctypes.POINTER(ctypes.c_double)
F32 = ctypes.POINTER(ctypes.c_float)
U16 = ctypes.POINTER(ctypes.c_uint16)
U8 = ctypes.POINTER(ctypes.c_uint8)

_lib = None


def build_shared(argv: list[str], src: str, so: str,
                 libs: list[str] = ()) -> str:
    """Compile `src` into the shared library `so` with `argv` (the
    compiler and its flags; the output path, the source and `libs` are
    appended), unless `so` is newer than `src`.  The library is written
    to a private temporary name and renamed into place, so concurrent
    processes never load a half-written file.  Returns the compiler's
    output; raises RuntimeError with it if the build fails."""
    if not os.path.exists(src):
        raise FileNotFoundError(f"kernel source not found: {src}")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return ""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(argv + ["-o", tmp, src, *libs], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(so)} failed "
                f"(rc {r.returncode}):\n{' '.join(argv)}\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return r.stdout + r.stderr


# the CUDA kernels' build: sm_90a (Hopper), ptxas reports each kernel's
# registers and spills into the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


_cuda_libs: dict = {}


def load_cuda(name: str, argtypes: dict):
    """Build `csrc/<name>.cu` with nvcc into `_build/lib<name>.so`
    (unless current), load it once per process and bind its entry
    points, `argtypes` = {entry point: ctypes argument types}; each
    returns a C int (the CUDA error of its launch).  Returns (library,
    compiler output of this call's build, empty when nothing was
    built)."""
    if name in _cuda_libs:
        return _cuda_libs[name], ""
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    log = build_shared([_nvcc(), *NVCC_FLAGS],
                       os.path.join(CSRC_DIR, f"{name}.cu"), so)
    lib = ctypes.CDLL(so)
    for entry, types in argtypes.items():
        fn = getattr(lib, entry)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    _cuda_libs[name] = lib
    return lib, log


def _bind(lib) -> None:
    sig = {
        "gs_levels": (None, [I64, I64, ctypes.c_int64, ctypes.c_int, I64]),
        "strength_classical_i32": (
            ctypes.c_int64,
            [I32, I32, F64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
             ctypes.c_int, I32, I32]),
        "pmis_loop": (
            None, [I64, I64, ctypes.c_int64, F64, I64, ctypes.c_int]),
        "rs_coarsen": (None, [I64, I64, I64, I64, ctypes.c_int64, I64]),
        "cljp_coarsen": (None, [I64, I64, ctypes.c_int64, F64, I64]),
        "classical_interp_fill": (
            ctypes.c_int64,
            [I64, I64, F64, F64, I64, I64, I64, I64, ctypes.c_int64,
             I64, I64, F64]),
        "ext_pi_interp": (
            ctypes.c_int64,
            [I64, I64, F64, I64, I64, I64, ctypes.c_int64, I64, I64, F64,
             ctypes.c_int64]),
        "trunc_keep": (
            None, [I64, I64, F64, ctypes.c_int64, ctypes.c_int64, U8]),
        "nongalerkin_count_i32": (
            ctypes.c_int64,
            [I32, I32, F64, ctypes.c_int64, ctypes.c_double, U8, I64]),
        "nongalerkin_fill_i32": (
            None,
            [I32, I32, F64, ctypes.c_int64, ctypes.c_int, U8, I64, I32, F64]),
        "dia_offsets_i32": (
            ctypes.c_int64, [I32, I32, ctypes.c_int64, ctypes.c_int64, U8, I64]),
        "coo_dia_offsets": (
            ctypes.c_int64,
            [I64, I64, ctypes.c_int64, ctypes.c_int64, U8, I64, I64]),
        "embedded_offsets_i32": (
            ctypes.c_int64,
            [I32, I32, ctypes.c_int64, I64, I64, ctypes.c_int64, U8, I64, I64]),
        "embedded_offsets_i64": (
            ctypes.c_int64,
            [I64, I64, ctypes.c_int64, I64, I64, ctypes.c_int64, U8, I64, I64]),
    }
    # the ILU factorizations return malloc'd CSR triples (L without its
    # unit diagonal, U with its diagonal first in each row) through six
    # out-pointers; ilu_free_ptr releases each
    outs = [ctypes.POINTER(I64), ctypes.POINTER(I64), ctypes.POINTER(F64)] * 2
    sig["iluk_factor"] = (ctypes.c_int, [I64, I64, F64, ctypes.c_int64,
                                         ctypes.c_int, *outs])
    sig["ilut_factor"] = (ctypes.c_int, [I64, I64, F64, ctypes.c_int64,
                                         ctypes.c_double, ctypes.c_int64,
                                         *outs])
    sig["ilu_free_ptr"] = (None, [ctypes.c_void_p])
    for name, P in (("dia_fill_i32_f64", F64), ("dia_fill_i32_f32", F32),
                    ("dia_fill_i32_bf16", U16)):
        sig[name] = (None, [I32, I32, F64, ctypes.c_int64, ctypes.c_int64,
                            I64, ctypes.c_int64, ctypes.c_int64, P])
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load():
    """Build (if stale) and load the host kernel library."""
    global _lib
    if _lib is None:
        build_shared(["cc", "-O3", "-shared", "-fPIC"], _SRC, _SO, ["-lm"])
        lib = ctypes.CDLL(_SO)
        _bind(lib)
        _lib = lib
    return _lib


def _p(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _i32_csr(M):
    """(indptr, indices, data) of M as int32 / int32 / float64 arrays
    (no copy when they already are)."""
    if M.nnz >= 2**31 or max(M.shape) >= 2**31:
        raise ValueError(f"matrix too large for int32 indices: {M.shape}")
    return (np.ascontiguousarray(M.indptr, dtype=np.int32),
            np.ascontiguousarray(M.indices, dtype=np.int32),
            np.ascontiguousarray(M.data, dtype=np.float64))


def gs_levels(indptr, indices, n: int, forward: bool) -> np.ndarray:
    """level[i] of the Gauss-Seidel wavefront DAG (par_relax.c:472-560):
    1 + the largest level of the earlier (forward) or later (backward)
    rows that row i reads, 0 for a row that reads none."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    level = np.zeros(n, dtype=np.int64)
    lib.gs_levels(_p(indptr, I64), _p(indices, I64), n, int(forward),
                  _p(level, I64))
    return level


def _ilu_csr_inputs(indptr, indices, data):
    return (np.ascontiguousarray(indptr, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.int64),
            np.ascontiguousarray(data, dtype=np.float64))


def _ilu_collect(lib, n: int, outs):
    """Copy the kernel's six malloc'd arrays into numpy and free them:
    ((Lp, Li, Lx), (Up, Ui, Ux))."""

    def take(ptr, count, np_dt):
        arr = (np.ctypeslib.as_array(ptr, shape=(count,)).astype(np_dt)
               if count else np.zeros(0, np_dt))
        lib.ilu_free_ptr(ptr)
        return arr

    lp_, li_, lx_, up_, ui_, ux_ = outs
    lp = take(lp_, n + 1, np.int64)
    li = take(li_, int(lp[-1]), np.int64)
    lx = take(lx_, int(lp[-1]), np.float64)
    up = take(up_, n + 1, np.int64)
    ui = take(ui_, int(up[-1]), np.int64)
    ux = take(ux_, int(up[-1]), np.float64)
    return (lp, li, lx), (up, ui, ux)


def _ilu_outs():
    """Six fresh out-pointers: (Lp, Li, Lx, Up, Ui, Ux)."""
    return [t() for t in (I64, I64, F64) * 2]


def iluk_factor(indptr, indices, data, n: int, fill: int):
    """ILU(k) level-of-fill factorization of a CSR with sorted indices
    (the Euclid ilu_mpi_pilu.c role): ((Lp, Li, Lx), (Up, Ui, Ux)), L
    strictly lower (its unit diagonal implicit), U with the diagonal."""
    lib = load()
    ip, ix, dx = _ilu_csr_inputs(indptr, indices, data)
    outs = _ilu_outs()
    lib.iluk_factor(_p(ip, I64), _p(ix, I64), _p(dx, F64), n, int(fill),
                    *[ctypes.byref(o) for o in outs])
    return _ilu_collect(lib, n, outs)


def ilut_factor(indptr, indices, data, n: int, droptol: float, maxrow: int):
    """Dual-threshold ILUT (Saad; the par_ilu_setup.c ILUT role) of a
    CSR with sorted indices; returns what iluk_factor does."""
    lib = load()
    ip, ix, dx = _ilu_csr_inputs(indptr, indices, data)
    outs = _ilu_outs()
    lib.ilut_factor(_p(ip, I64), _p(ix, I64), _p(dx, F64), n, float(droptol),
                    int(maxrow), *[ctypes.byref(o) for o in outs])
    return _ilu_collect(lib, n, outs)


def strength_classical(M: sp.csr_matrix, theta: float, max_row_sum: float,
                       sabs: bool = False):
    """Classical strength pattern (par_strength.c), or with sabs the
    absolute-value one (hypre_BoomerAMGCreateSabs); scipy pattern CSR
    with data ones and the diagonal excluded."""
    lib = load()
    ai, aj, ad = _i32_csr(M)
    n = M.shape[0]
    Sp = np.empty(n + 1, dtype=np.int32)
    Si = np.empty(max(M.nnz, 1), dtype=np.int32)
    nnz = lib.strength_classical_i32(
        _p(ai, I32), _p(aj, I32), _p(ad, F64), n, theta, max_row_sum,
        1 if sabs else 0, _p(Sp, I32), _p(Si, I32))
    return sp.csr_matrix(
        (np.ones(int(nnz), dtype=np.float32), Si[:nnz], Sp), shape=(n, n))


def pmis_loop(S_indptr, S_indices, n: int, measure, cf,
              first_round_is: bool) -> np.ndarray:
    """PMIS iterated independent set; returns the CF marker (inputs are
    copied, not mutated)."""
    lib = load()
    sp_ = np.ascontiguousarray(S_indptr, dtype=np.int64)
    si_ = np.ascontiguousarray(S_indices, dtype=np.int64)
    meas = np.array(measure, dtype=np.float64)
    cfa = np.array(cf, dtype=np.int64)
    lib.pmis_loop(_p(sp_, I64), _p(si_, I64), n, _p(meas, F64), _p(cfa, I64),
                  1 if first_round_is else 0)
    return cfa


def rs_coarsen(S: sp.csr_matrix) -> np.ndarray:
    """Ruge-Stueben first pass (par_coarsen.c:874) over the strength
    pattern S; returns the CF marker (1 C, -1 F, -3 isolated)."""
    lib = load()
    n = S.shape[0]
    ST = S.T.tocsr()
    ST.sort_indices()
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (S.indptr, S.indices, ST.indptr, ST.indices)]
    cf = np.zeros(n, dtype=np.int64)
    lib.rs_coarsen(*(_p(a, I64) for a in args), n, _p(cf, I64))
    return cf


def cljp_coarsen(S_indptr, S_indices, n: int, measure) -> np.ndarray:
    """CLJP coarsening (par_coarsen.c:93); returns the CF marker.  The
    kernel consumes its copies of S_indices and measure."""
    lib = load()
    indptr = np.ascontiguousarray(S_indptr, dtype=np.int64)
    indices = np.array(S_indices, dtype=np.int64)
    meas = np.array(measure, dtype=np.float64)
    cf = np.zeros(n, dtype=np.int64)
    lib.cljp_coarsen(_p(indptr, I64), _p(indices, I64), n, _p(meas, F64),
                     _p(cf, I64))
    return cf


def classical_interp_fill(A: sp.csr_matrix, S: sp.csr_matrix, cf, cmap):
    """Modified classical interpolation (par_interp.c); scipy CSR P."""
    lib = load()
    n = A.shape[0]
    ai = np.ascontiguousarray(A.indptr, dtype=np.int64)
    aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    ad = np.ascontiguousarray(A.data, dtype=np.float64)
    diag = np.ascontiguousarray(A.diagonal(), dtype=np.float64)
    sp_ = np.ascontiguousarray(S.indptr, dtype=np.int64)
    si_ = np.ascontiguousarray(S.indices, dtype=np.int64)
    cfa = np.ascontiguousarray(cf, dtype=np.int64)
    cm = np.ascontiguousarray(cmap, dtype=np.int64)
    cap = int(S.nnz + n + 1)
    Pp = np.zeros(n + 1, dtype=np.int64)
    Pi = np.zeros(cap, dtype=np.int64)
    Px = np.zeros(cap, dtype=np.float64)
    nnz = lib.classical_interp_fill(
        _p(ai, I64), _p(aj, I64), _p(ad, F64), _p(diag, F64), _p(sp_, I64),
        _p(si_, I64), _p(cfa, I64), _p(cm, I64), n, _p(Pp, I64), _p(Pi, I64),
        _p(Px, F64))
    nc = int((np.asarray(cf) > 0).sum())
    return sp.csr_matrix(
        (Px[:nnz], Pi[:nnz].astype(np.int32), Pp.astype(np.int32)),
        shape=(n, nc))


def ext_pi_interp(A: sp.csr_matrix, S: sp.csr_matrix, cf):
    """Extended+i interpolation (par_lr_interp.c); (rows, cols, vals)
    COO triplets of P, in the kernel's fill order.  The kernel reports
    the entries it needed when they exceed the buffers; it then runs
    again with buffers that size (at most three runs, as the JAX
    package's binding does)."""
    lib = load()
    n = A.shape[0]
    ai = np.ascontiguousarray(A.indptr, dtype=np.int64)
    aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    ad = np.ascontiguousarray(A.data, dtype=np.float64)
    si = np.ascontiguousarray(S.indptr, dtype=np.int64)
    sj = np.ascontiguousarray(S.indices, dtype=np.int64)
    cfa = np.ascontiguousarray(cf, dtype=np.int64)
    cap = max(int(A.nnz * 4), 16)
    for _ in range(3):
        rows = np.zeros(cap, dtype=np.int64)
        cols = np.zeros(cap, dtype=np.int64)
        vals = np.zeros(cap, dtype=np.float64)
        nnz = lib.ext_pi_interp(
            _p(ai, I64), _p(aj, I64), _p(ad, F64), _p(si, I64), _p(sj, I64),
            _p(cfa, I64), n, _p(rows, I64), _p(cols, I64), _p(vals, F64), cap)
        if nnz <= cap:
            return rows[:nnz], cols[:nnz], vals[:nnz]
        cap = int(nnz) + 16
    raise RuntimeError(f"ext_pi_interp: {nnz} entries still exceed {cap}")


def trunc_keep(indptr, cols, vals, max_elmts: int) -> np.ndarray:
    """hypre-exact truncation keep mask (qsort2_abs tie order)."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    keep = np.zeros(len(cols), dtype=np.uint8)
    lib.trunc_keep(_p(indptr, I64), _p(cols, I64), _p(vals, F64),
                   len(indptr) - 1, max_elmts, _p(keep, U8))
    return keep.astype(bool)


def nongalerkin_filter_native(A: sp.csr_matrix, tol: float,
                              lump: str = "diag") -> sp.csr_matrix:
    """Non-Galerkin sparsification (par_nongalerkin.c role) of a CSR
    with sorted indices."""
    if not A.has_sorted_indices:
        raise ValueError("nongalerkin_filter_native needs sorted indices")
    lib = load()
    ip, ix, ax = _i32_csr(A)
    n = A.shape[0]
    keep2 = np.empty(max(A.nnz, 1), dtype=np.uint8)
    Cp = np.empty(n + 1, dtype=np.int64)
    nnz = lib.nongalerkin_count_i32(
        _p(ip, I32), _p(ix, I32), _p(ax, F64), n, tol, _p(keep2, U8),
        _p(Cp, I64))
    Ci = np.empty(max(nnz, 1), dtype=np.int32)
    Cx = np.empty(max(nnz, 1), dtype=np.float64)
    lib.nongalerkin_fill_i32(
        _p(ip, I32), _p(ix, I32), _p(ax, F64), n,
        1 if lump == "strong" else 0, _p(keep2, U8), _p(Cp, I64),
        _p(Ci, I32), _p(Cx, F64))
    out = sp.csr_matrix((Cx[:nnz], Ci[:nnz], Cp.astype(np.int32)),
                        shape=A.shape)
    # a fully lumped row can cancel its own diagonal; prune exact zeros
    # as the numpy path's final canonicalization does
    out.eliminate_zeros()
    return out


def dia_offsets_only(M: sp.csr_matrix) -> np.ndarray:
    """Sorted distinct diagonal offsets of a CSR pattern."""
    lib = load()
    ai, aj, _ = _i32_csr(M)
    n, m = M.shape
    mark = np.zeros(n + m - 1, dtype=np.uint8)
    uniq = np.zeros(n + m - 1, dtype=np.int64)
    noff = lib.dia_offsets_i32(_p(ai, I32), _p(aj, I32), n, m, _p(mark, U8),
                               _p(uniq, I64))
    return uniq[:noff].copy()


_FILL = {"float64": ("dia_fill_i32_f64", np.float64, F64),
         "float32": ("dia_fill_i32_f32", np.float32, F32),
         # bf16 is filled as its bit pattern (double -> float -> RNE bf16)
         "bfloat16": ("dia_fill_i32_bf16", np.uint16, U16)}


def dia_convert(M: sp.csr_matrix, dtype: str):
    """CSR -> row-aligned DIA, data[k, i] = M[i, i + uniq[k]], width n.

    Returns (uniq offsets int64, data [noff, n]); for dtype "bfloat16"
    the data array is uint16 holding the bf16 bit patterns."""
    lib = load()
    ai, aj, ad = _i32_csr(M)
    n, m = M.shape
    uniq = dia_offsets_only(M)
    fname, np_dt, ptype = _FILL[dtype]
    out = np.zeros((len(uniq), n), dtype=np_dt)
    getattr(lib, fname)(_p(ai, I32), _p(aj, I32), _p(ad, F64), n, m,
                        _p(uniq, I64), len(uniq), n, _p(out, ptype))
    return uniq, out


def _offset_scratch(n: int):
    """(mark, uniq, cnt) scratch of the offset-count kernels for an
    n-point lattice: one slot per possible offset in [-(n-1), n-1]."""
    span = max(2 * n - 1, 1)
    return (np.zeros(span, dtype=np.uint8), np.zeros(span, dtype=np.int64),
            np.zeros(span, dtype=np.int64))


def coo_dia_counts(rows, cols, n: int):
    """(sorted distinct offsets cols - rows, entries on each) of COO
    entries positioned on an n-point lattice."""
    lib = load()
    r = np.ascontiguousarray(rows, dtype=np.int64)
    c = np.ascontiguousarray(cols, dtype=np.int64)
    mark, uniq, cnt = _offset_scratch(n)
    noff = lib.coo_dia_offsets(_p(r, I64), _p(c, I64), len(r), n,
                               _p(mark, U8), _p(uniq, I64), _p(cnt, I64))
    return uniq[:noff].copy(), cnt[:noff].copy()


def embedded_counts(mrow, mcol, rpos, cpos, n: int):
    """(sorted distinct embedded offsets cpos[col] - rpos[row], entries
    on each); int32 row/col arrays are taken without a copy."""
    lib = load()
    mrow, mcol = np.asarray(mrow), np.asarray(mcol)
    if mrow.dtype == np.int32 and mcol.dtype == np.int32:
        fn, ptype = lib.embedded_offsets_i32, I32
        r, c = np.ascontiguousarray(mrow), np.ascontiguousarray(mcol)
    else:
        fn, ptype = lib.embedded_offsets_i64, I64
        r = np.ascontiguousarray(mrow, dtype=np.int64)
        c = np.ascontiguousarray(mcol, dtype=np.int64)
    rp = np.ascontiguousarray(rpos, dtype=np.int64)
    cp = np.ascontiguousarray(cpos, dtype=np.int64)
    mark, uniq, cnt = _offset_scratch(n)
    noff = fn(_p(r, ptype), _p(c, ptype), len(r), _p(rp, I64), _p(cp, I64), n,
              _p(mark, U8), _p(uniq, I64), _p(cnt, I64))
    return uniq[:noff].copy(), cnt[:noff].copy()
