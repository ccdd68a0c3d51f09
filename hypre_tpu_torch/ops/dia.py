"""DIA (diagonal) format, dense format, the lattice forms and the
polymorphic `spmv` (port of hypre_tpu/ops/dia.py).

Matrices whose nonzeros live on few distinct diagonals (the stencil
fine level) are stored as row-aligned diagonals, data[k, i] =
A[i, i + offsets[k]], exactly [noff, n]; small coarse matrices are
dense; everything else is slot-major ELL.  `freeze_auto` picks per
matrix with the JAX package's thresholds, so both packages freeze a
hierarchy into the same formats.

`dia_spmv` dispatches on the device of x alone: a CUDA tensor launches
the hand-written kernel K1 (ops/dia_kernel.py) or raises; a CPU tensor
takes K1's plain torch version.  `spmv_resid`, `spmv_axpy` and
`spmv_jacobi` are the matvec with the elementwise work that follows it
in the V-cycle (ops/forms.py), one kernel launch each on the card for
DIA and ELL operators; every other operator runs its plain matvec and
then the form's elementwise torch ops.

The lattice forms (the JAX package's default solve path) trade padded
bandwidth for gathers: a coarse operator whose unknowns sit on a
sub-lattice is lifted onto the lattice as DIA (`build_embedded_dia`),
its rare diagonals split off into an exact `COOTail`; a coarse grid
relocated onto a regular cell lattice (`relocate_to_cells`) gets its
grid transfers as sums of square DIA operators, one per fine-parity
class (`ParityRestrictOp`, `ParityInterpOp`); `GatherOp` / `ScatterOp`
wrap a compact operator below the last relocated level.  On the card
every DIA part is a K1 launch and every tail rides in the K1 launch
beside it (`dia_spmv(..., tail=)`): a DIAWithTail in any form is one
launch, each parity class of an interpolation carries its share of the
tail, a restriction's tail rides on its first launch.  A dense operator
on relocated cells (`on_cells`, the collapsed coarse solve) is one
`cell_dense` launch (ops/cell_dense_kernel.py); every other GatherOp's
x[pos] is one `flat_take` launch (ops/gather_kernel.py).  Unlike the
JAX package there is no width padding and no deferred host image: a DIA
image is `torch.zeros` on the device filled by one indexed write of its
compact (index, value) pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from .csr import CSRMatrix, ELLMatrix, to_device, torch_dtype
from .cell_dense_kernel import cell_dense
from .dia_kernel import dia_spmv_cuda, dia_spmv_reference
from .forms import epilogue
from .gather_kernel import flat_take
from .spmv import ell_spmv
from .tail_kernel import coo_tail

# freeze_auto's thresholds, the JAX package's (picked there for the TPU;
# re-deriving them for the H100 is open work, see PERF.md)
DIA_MAX_OFFSETS = 48
DENSE_MAX_ROWS = 6144


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Square, data[k, i] = A[i, i + offsets[k]]; offsets sorted."""

    data: torch.Tensor  # [noff, n]
    offsets: tuple
    num_rows: int
    num_cols: int

    def __post_init__(self):
        if self.num_rows != self.num_cols:
            raise ValueError(
                f"DIAMatrix is square only, got {self.num_rows}x{self.num_cols}")
        if tuple(self.data.shape) != (len(self.offsets), self.num_rows):
            raise ValueError(
                f"DIA data {tuple(self.data.shape)} does not match "
                f"{len(self.offsets)} offsets x {self.num_rows} rows")


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    data: torch.Tensor  # [n, m]
    num_rows: int
    num_cols: int


def csr_to_dia(A: CSRMatrix, dtype, device) -> DIAMatrix:
    """Square CSR -> DIA on `device` (native one-pass conversion)."""
    n, m = A.shape
    if n != m:
        raise ValueError(f"csr_to_dia needs a square matrix, got {n}x{m}")
    dt = torch_dtype(dtype)
    uniq, data = native.dia_convert(A.to_scipy(), str(dt).split(".")[-1])
    if dt == torch.bfloat16:
        t = torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(data)
    return DIAMatrix(data=t.to(device), offsets=tuple(int(o) for o in uniq),
                     num_rows=n, num_cols=m)


def device_lattice_dia(shape, coeffs, dtype, device) -> DIAMatrix | None:
    """The DIA table of the 3D 7-point Laplacian (the values of
    `models.laplacian_7pt(*shape, *coeffs)`) built on `device` from
    index masks, so the fine operator costs no host-to-device bytes;
    bitwise `csr_to_dia` of that matrix.  None when the stencil is not
    the full 7-point one (an axis shorter than 2, a zero coefficient)."""
    nx, ny, nz = (int(s) for s in shape)
    cx, cy, cz = (float(c) for c in coeffs)
    if min(nx, ny, nz) < 2 or not (cx and cy and cz):
        return None
    n = nx * ny * nz
    diag = 0.0  # summed as laplacian_7pt sums it
    for c in (cx, cy, cz):
        diag += 2.0 * c
    idx = torch.arange(n, device=device)
    coord = ((idx // (nx * ny), nz, cz), ((idx // nx) % ny, ny, cy),
             (idx % nx, nx, cx))
    offs = (-nx * ny, -nx, -1, 0, 1, nx, nx * ny)
    data = torch.zeros(len(offs), n, dtype=torch_dtype(dtype), device=device)
    data[3].fill_(diag)
    for k, (u, lim, c) in enumerate(coord):  # offsets -stride and +stride
        data[k].masked_fill_(u >= 1, -c)
        data[6 - k].masked_fill_(u + 1 < lim, -c)
    return DIAMatrix(data=data, offsets=offs, num_rows=n, num_cols=n)


def dia_spmv(A: DIAMatrix, x: torch.Tensor, form: str = "plain",
             **operands) -> torch.Tensor:
    """The form (ops/forms.py) of y_i = sum_k data[k,i] * x[i + off_k]:
    K1 on CUDA, plain on CPU."""
    if x.device.type == "cuda":
        return dia_spmv_cuda(A.data, A.offsets, x, form, **operands)
    if x.device.type == "cpu":
        return dia_spmv_reference(A.data, A.offsets, x, form, **operands)
    raise ValueError(f"dia_spmv: no path for device {x.device}")


def dense_spmv(A: DenseMatrix, x: torch.Tensor) -> torch.Tensor:
    # torch.matmul refuses mixed dtypes (jnp promotes): widen explicitly
    return A.data.to(x.dtype) @ x


def freeze_auto(A: CSRMatrix, dtype, device):
    """Pick the device format for this matrix: dense if small, DIA if
    square with few distinct diagonals, ELL otherwise."""
    n, m = A.shape
    if n <= DENSE_MAX_ROWS and m <= DENSE_MAX_ROWS:
        return DenseMatrix(
            data=to_device(A.to_scipy().toarray(), torch_dtype(dtype), device),
            num_rows=n,
            num_cols=m,
        )
    if n == m and A.nnz:
        if len(native.dia_offsets_only(A.to_scipy())) <= DIA_MAX_OFFSETS:
            return csr_to_dia(A, dtype, device)
    return A.to_ell(dtype, device)


# ---------------------------------------------------------------------------
# The exact low-frequency remainder of a lattice operator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class COOTail:
    """Entries of a lattice operator on diagonals too rare to store as
    DIA rows (a stored diagonal streams the whole lattice width whatever
    it carries): sorted COO, applied by gather, ordered segment sum and
    an add on the distinct rows.  The operator stays exact; only the
    evaluation is split by diagonal frequency.

    The JAX package keeps `seg` (entry -> index into rows_u); the port
    keeps the segment pointers `coo_tail` walks, and derives `seg`.  K1
    carries a tail in its own launch through `row_ptr`, the same
    segments over every output row of the operator."""

    rows_u: torch.Tensor   # int32 [nseg]      distinct output rows, sorted
    seg_ptr: torch.Tensor  # int32 [nseg + 1]  entries of row s: [seg_ptr[s], seg_ptr[s+1])
    cols: torch.Tensor     # int32 [T]
    vals: torch.Tensor     # [T]
    row_ptr: torch.Tensor  # int32 [n_rows + 1] entries of output row i: [row_ptr[i], row_ptr[i+1])

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def seg(self) -> torch.Tensor:
        """int32 [T], entry -> index into rows_u (the JAX package's field)."""
        n = self.rows_u.shape[0]
        return torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=self.rows_u.device),
            torch.diff(self.seg_ptr).long())

    def k1(self, x=None) -> tuple:
        """The tail as K1 takes it (`dia_spmv(..., tail=)`), gathering
        from x, or from K1's own x when None."""
        return (self.row_ptr, self.cols, self.vals, x)


def tail_apply(tail: COOTail, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += tail @ x, in place on y (the tensor the DIA part just made):
    the `coo_tail` kernel on CUDA, its plain version on CPU."""
    return coo_tail(tail.vals, tail.cols, tail.seg_ptr, tail.rows_u, x, y)


def tail_on_rows(rows: np.ndarray, cols: torch.Tensor, vals: torch.Tensor,
                 n_rows: int) -> COOTail:
    """The COOTail of entries (cols, vals: int32 and value tensors on the
    device) whose host output rows `rows` are sorted, on an operator of
    n_rows output rows."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) and (np.diff(rows) < 0).any():
        raise ValueError("tail_on_rows: rows must be sorted")
    rows_u, counts = np.unique(rows, return_counts=True)
    seg_ptr = np.concatenate(([0], np.cumsum(counts)))
    row_ptr = np.concatenate(
        ([0], np.cumsum(np.bincount(rows, minlength=n_rows))))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(vals.device)  # noqa: E731
    return COOTail(rows_u=i32(rows_u), seg_ptr=i32(seg_ptr), cols=cols,
                   vals=vals, row_ptr=i32(row_ptr))


def _build_tail(rows, cols, vals, dtype, device, n_rows=None) -> COOTail:
    """The tail of COO entries on an operator of n_rows output rows (by
    default one past the largest row), each row's entries in the order
    given."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if n_rows is None:
        n_rows = int(rows[-1]) + 1 if len(rows) else 0
    return tail_on_rows(
        rows, torch.from_numpy(cols.astype(np.int32)).to(device),
        to_device(vals, torch_dtype(dtype), device), n_rows)


@dataclasses.dataclass(frozen=True)
class DIAWithTail:
    """Hybrid lattice operator: streamed DIA majority + exact COOTail."""

    dia: DIAMatrix
    tail: COOTail

    @property
    def num_rows(self) -> int:
        return self.dia.num_rows

    @property
    def num_cols(self) -> int:
        return self.dia.num_cols


def tail_min_count(ncells: int, itemsize: int) -> int:
    """Keep a diagonal in DIA only if it carries at least this many
    entries: count >= ncells * itemsize * 3.36e-4 + 37.  The constants
    are the JAX package's, a break-even measured on a TPU (streamed
    bytes and kernel dispatch per stored diagonal against the cost of a
    tail entry), not the card's: the formula is kept so both packages
    split the same diagonals into the tail."""
    return max(2, int(ncells * itemsize * 3.36e-4) + 37)


# ---------------------------------------------------------------------------
# Lattice embedding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatherOp:
    """Compress-then-apply: y = inner @ x[pos] (embedded -> compressed)."""

    inner: object
    pos: torch.Tensor  # int32 [k], as the flat_take kernel takes it

    @property
    def num_rows(self) -> int:
        return self.inner.num_rows


@dataclasses.dataclass(frozen=True)
class ScatterOp:
    """Apply-then-embed: y = zeros(n_out); y[pos] = inner @ x.

    `row_of_cell` is set (by `on_cells`) on a ScatterOp(GatherOp(dense))
    that gathers from and scatters to the same positions: output entry
    c takes the dense operator's row row_of_cell[c], -1 for none.  That
    operator is one `cell_dense` launch on the card."""

    inner: object
    pos: torch.Tensor  # int64 [inner.num_rows], as torch's indexed write takes it
    n_out: int
    row_of_cell: torch.Tensor | None = None  # int32 [n_out]

    @property
    def num_rows(self) -> int:
        return self.n_out


def on_cells(dense: DenseMatrix, cells: np.ndarray, n_cells: int,
             device) -> ScatterOp:
    """A square dense operator on points that sit at the distinct
    positions `cells` of an n_cells lattice: y[cells[r]] = sum_j
    dense[r, j] * x[cells[j]], zero off `cells`."""
    cells = np.asarray(cells, dtype=np.int64)
    if dense.num_rows != dense.num_cols or len(cells) != dense.num_rows:
        raise ValueError(f"on_cells: a square operator with one cell a row, "
                         f"got {dense.num_rows}x{dense.num_cols} on "
                         f"{len(cells)} cells")
    row_of_cell = np.full(n_cells, -1, dtype=np.int32)
    row_of_cell[cells] = np.arange(len(cells), dtype=np.int32)
    if (row_of_cell >= 0).sum() != len(cells):
        raise ValueError("on_cells: the cells are not distinct")
    return ScatterOp(
        inner=GatherOp(inner=dense, pos=torch.from_numpy(
            cells.astype(np.int32)).to(device)),
        pos=torch.from_numpy(cells).to(device), n_out=n_cells,
        row_of_cell=torch.from_numpy(row_of_cell).to(device))


def _uniq_offsets(offs: np.ndarray, n: int, m: int):
    """(sorted distinct offsets, inverse) for diagonal offsets bounded in
    [-(n-1), m-1]: a presence bitmap + searchsorted against the few
    distinct diagonals, one linear pass."""
    if offs.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    present = np.zeros(n + m - 1, dtype=bool)
    present[offs + (n - 1)] = True
    uniq = np.flatnonzero(present) - (n - 1)
    return uniq, np.searchsorted(uniq, offs)


def _dia_scatter(k, rows, vals, uniq, n: int, dtype, device) -> DIAMatrix:
    """The n x n DIA operator with data[k[e], rows[e]] = vals[e] on
    distinct (k, rows) pairs: the compact pairs go to the device and one
    indexed write fills a zero image there (the embedded level-1 image
    is ~97% zeros: it is never built on the host).  bfloat16 values are
    rounded f64 -> f32 -> bf16 (nearest even), as the native fill does."""
    dt = torch_dtype(dtype)
    noff = len(uniq)
    data = torch.zeros(noff * n, dtype=dt, device=device)
    if len(vals):
        flat = np.asarray(k, dtype=np.int64) * n + np.asarray(rows, dtype=np.int64)
        data[torch.from_numpy(flat).to(device)] = to_device(vals, dt, device)
    return DIAMatrix(data=data.view(noff, n),
                     offsets=tuple(int(o) for o in uniq), num_rows=n, num_cols=n)


def build_embedded_dia(M, rpos: np.ndarray, cpos: np.ndarray, n_emb: int,
                       dtype, device, tail_min: int = 0):
    """Lift a compressed sparse operator onto a lattice embedding.

    M: scipy sparse with rows indexed by `rpos` lattice positions and
    cols by `cpos` positions.  Returns a DIA operator over the n_emb
    lattice: out[rpos[r]] = sum_c M[r,c] * x[cpos[c]], rows off rpos stay
    zero.  With tail_min, diagonals carrying fewer entries go to a
    COOTail (a DIAWithTail comes back) unless that would take all or
    none of them."""
    Mc = M.tocoo()
    rows_emb = rpos[Mc.row]
    cols_emb = cpos[Mc.col]
    vals = Mc.data
    uniq, cnt = native.coo_dia_counts(rows_emb, cols_emb, n_emb)
    # inverse via an O(nnz) lut gather (no per-entry searchsorted)
    lut = np.zeros(2 * n_emb - 1, dtype=np.int64)
    lut[uniq + (n_emb - 1)] = np.arange(len(uniq))
    k = lut[cols_emb - rows_emb + (n_emb - 1)]
    tail = None
    if tail_min:
        low = cnt < tail_min
        if low.any() and not low.all():
            in_tail = low[k]
            tail = _build_tail(rows_emb[in_tail], cols_emb[in_tail],
                               vals[in_tail], dtype, device, n_rows=n_emb)
            # the kept diagonals, renumbered
            renum = np.cumsum(~low) - 1
            rows_emb, vals, k = (rows_emb[~in_tail], vals[~in_tail],
                                 renum[k[~in_tail]])
            uniq = uniq[~low]
    dia = _dia_scatter(k, rows_emb, vals, uniq, n_emb, dtype, device)
    return DIAWithTail(dia=dia, tail=tail) if tail is not None else dia


def _embedded_counts(M, rpos, cpos):
    """(uniq embedded offsets, per-offset counts), native: no nnz-sized
    temporaries (the relocation planner calls this per level)."""
    Mc = M.tocoo()
    if Mc.nnz == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    n = max(int(rpos.max()), int(cpos.max())) + 1
    return native.embedded_counts(Mc.row, Mc.col, rpos, cpos, n)


def embedded_offsets(M, rpos, cpos) -> np.ndarray:
    """Sorted distinct lattice offsets of the embedded form of M."""
    return _embedded_counts(M, rpos, cpos)[0]


def embedded_offset_count(M, rpos, cpos, tail_min: int = 0) -> int:
    """Distinct embedded offsets; with tail_min, only those KEPT by a
    tailed build (carrying >= tail_min entries)."""
    uniq, cnt = _embedded_counts(M, rpos, cpos)
    if not tail_min:
        return len(uniq)
    if len(uniq) == 0:
        return 0
    kept = int((cnt >= tail_min).sum())
    return kept if kept else len(cnt)


# ---------------------------------------------------------------------------
# Parity-factored (octant) lattice transfer operators
#
# When an AMG coarse level is RELOCATED onto a regular sub-lattice (each
# coarse point assigned a distinct cell of the factor-coarsened lattice,
# see solvers/amg/boomeramg.py), the restriction R: fine -> cells and
# interpolation P: cells -> fine become strided stencil operators.  A
# strided stencil is a sum over fine-parity classes of SQUARE DIA
# operators on the cell lattice: splitting x by parity class makes every
# tap a plain diagonal shift, so the transfers run on K1.
# ---------------------------------------------------------------------------

def _parity_index(px, py, pz, factors):
    fx, fy, fz = factors
    return (pz * fy + py) * fx + px


def parity_split(x: torch.Tensor, fine_shape, factors) -> torch.Tensor:
    """Split a flat fine-lattice vector (x-fastest: gid = ix + nx*(iy +
    ny*iz)) into its parity sub-lattice vectors, cell-lattice flat: a
    contiguous [B, ncells] tensor (one strided copy) whose row
    _parity_index(px, py, pz) is the JAX package's part of that class."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    x6 = x.view(nz // fz, fz, ny // fy, fy, nx // fx, fx)
    return x6.permute(1, 3, 5, 0, 2, 4).reshape(fx * fy * fz, -1)


def parity_merge(parts: torch.Tensor, fine_shape, factors) -> torch.Tensor:
    """Inverse of parity_split: recombine the [B, ncells] per-parity cell
    vectors into a flat fine-lattice vector (one permuted copy)."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    y = parts.view(fz, fy, fx, nz // fz, ny // fy, nx // fx)
    return y.permute(3, 0, 4, 1, 5, 2).reshape(nz * ny * nx)


@dataclasses.dataclass(frozen=True)
class ParityRestrictOp:
    """R: fine lattice -> cell lattice; y = sum_p mats[p] @ split_p(x)."""

    mats: tuple  # one DIAMatrix per parity class, square on the cell lattice
    fine_shape: tuple
    factors: tuple
    # exact rare-diagonal remainder: rows = cells, cols = FLAT fine
    tail: COOTail | None = None

    @property
    def num_rows(self) -> int:
        return self.mats[0].num_rows

    @property
    def num_cols(self) -> int:
        nx, ny, nz = self.fine_shape
        return nx * ny * nz


@dataclasses.dataclass(frozen=True)
class ParityInterpOp:
    """P: cell lattice -> fine lattice; y = merge_p(mats[p] @ x)."""

    mats: tuple  # one DIAMatrix per parity class, square on the cell lattice
    fine_shape: tuple
    factors: tuple
    # exact rare-diagonal remainder: rows = FLAT fine, cols = cells
    tail: COOTail | None = None
    # the same entries split by the parity class of their row, on cell
    # rows (one COOTail or None a class), as the classes' K1 launches
    # carry them; set whenever `tail` is
    class_tails: tuple | None = None

    def __post_init__(self):
        if (self.tail is None) != (self.class_tails is None):
            raise ValueError("ParityInterpOp: class_tails goes with tail")

    @property
    def num_rows(self) -> int:
        nx, ny, nz = self.fine_shape
        return nx * ny * nz

    @property
    def num_cols(self) -> int:
        return self.mats[0].num_cols


def _cells_of_fine(idx, fine_shape, factors):
    """Fine flat index -> (cell flat index, parity index)."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    cx, px = ix // fx, ix % fx
    cy, py = iy // fy, iy % fy
    cz, pz = iz // fz, iz % fz
    cells = cx + (nx // fx) * (cy + (ny // fy) * cz)
    return cells, _parity_index(px, py, pz, factors)


def dia_from_coo(rows, cols, vals, n: int, dtype, device) -> DIAMatrix:
    """Square n x n DIA directly from UNIQUE (row, col) coordinate
    entries, without a scipy CSR roundtrip."""
    uniq, k = _uniq_offsets(cols - rows, n, n)
    return _dia_scatter(k, rows, vals, uniq, n, dtype, device)


def _per_parity_dia(rows_cell, cols_cell, parity, vals, ncells, nparity, dtype,
                    device):
    # fine index <-> (cell, parity) is a bijection, so entries within one
    # parity class are unique (row, col) pairs: no dedup needed
    mats = []
    for p in range(nparity):
        m = parity == p
        mats.append(dia_from_coo(rows_cell[m], cols_cell[m], vals[m], ncells,
                                 dtype, device))
    return tuple(mats)


def _parity_tail_mask(rows_cell, cols_cell, parity, ncells, tail_min):
    """Entries on (parity, offset) diagonals with < tail_min entries."""
    key = parity.astype(np.int64) * (2 * ncells + 1) + (
        cols_cell - rows_cell + ncells
    )
    ukey, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    low = cnt[inv] < tail_min
    return low if low.any() and not low.all() else None


def build_parity_restrict(M, rcell, fine_shape, factors, dtype, device,
                          tail_min: int = 0):
    """M: scipy sparse (n_pts x n_fine) with rows = coarse points, cols =
    fine lattice indices; rcell[i] = assigned cell of point i."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ncells = (nx // fx) * (ny // fy) * (nz // fz)
    Mc = M.tocoo()
    ccell, par = _cells_of_fine(Mc.col.astype(np.int64), fine_shape, factors)
    rows_cell, vals = rcell[Mc.row], Mc.data
    cols_fine = Mc.col.astype(np.int64)
    tail = None
    if tail_min:
        low = _parity_tail_mask(rows_cell, ccell, par, ncells, tail_min)
        if low is not None:
            tail = _build_tail(rows_cell[low], cols_fine[low], vals[low],
                               dtype, device, n_rows=ncells)
            rows_cell, ccell, par, vals = (
                rows_cell[~low], ccell[~low], par[~low], vals[~low]
            )
    mats = _per_parity_dia(rows_cell, ccell, par, vals, ncells, fx * fy * fz,
                           dtype, device)
    return ParityRestrictOp(mats=mats, fine_shape=tuple(fine_shape),
                            factors=tuple(factors), tail=tail)


def build_parity_interp(M, ccol, fine_shape, factors, dtype, device,
                        tail_min: int = 0):
    """M: scipy sparse (n_fine x n_pts) with rows = fine lattice indices,
    cols = coarse points; ccol[j] = assigned cell of point j."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ncells = (nx // fx) * (ny // fy) * (nz // fz)
    Mc = M.tocoo()
    rcell, par = _cells_of_fine(Mc.row.astype(np.int64), fine_shape, factors)
    cols_cell, vals = ccol[Mc.col], Mc.data
    rows_fine = Mc.row.astype(np.int64)
    nparity = fx * fy * fz
    tail = class_tails = None
    if tail_min:
        low = _parity_tail_mask(rcell, cols_cell, par, ncells, tail_min)
        if low is not None:
            tail = _build_tail(rows_fine[low], cols_cell[low], vals[low],
                               dtype, device, n_rows=nx * ny * nz)
            class_tails = split_interp_tail(tail, fine_shape, factors)
            rcell, cols_cell, par, vals = (
                rcell[~low], cols_cell[~low], par[~low], vals[~low]
            )
    mats = _per_parity_dia(rcell, cols_cell, par, vals, ncells, nparity,
                           dtype, device)
    return ParityInterpOp(mats=mats, fine_shape=tuple(fine_shape),
                          factors=tuple(factors), tail=tail,
                          class_tails=class_tails)


def split_interp_tail(tail: COOTail, fine_shape, factors) -> tuple:
    """An interpolation's tail (rows = flat fine) split by the parity
    class of its rows, on cell rows: one COOTail (or None) a class.  A
    fine row is one (cell, class) pair, and within a class the cells rise
    with the fine rows, so each class's tail holds its rows' entries in
    the order the whole tail does, values untouched."""
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ncells = (nx // fx) * (ny // fy) * (nz // fz)
    counts = torch.diff(tail.seg_ptr).long().cpu()
    rows = torch.repeat_interleave(tail.rows_u.long().cpu(), counts).numpy()
    cells, parity = _cells_of_fine(rows, fine_shape, factors)
    out = []
    for p in range(fx * fy * fz):
        m = np.flatnonzero(parity == p)
        if not len(m):
            out.append(None)
            continue
        idx = torch.from_numpy(m).to(tail.vals.device)
        out.append(tail_on_rows(cells[m], tail.cols[idx], tail.vals[idx],
                                ncells))
    return tuple(out)


def parity_offset_count(ops) -> int:
    return sum(len(m.offsets) for m in ops.mats)


def parity_offset_count_plan(
    M, point_cell, fine_shape, factors, restrict: bool, tail_min: int = 0
) -> int:
    """Total DIA offsets a parity restrict/interp build would produce,
    WITHOUT building it (setup planning).  restrict=True: M rows are
    points (cells via point_cell), cols are fine lattice indices;
    restrict=False: the transpose convention (build_parity_interp)."""
    Mc = M.tocoo()
    if Mc.nnz == 0:
        return 0
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ncells = (nx // fx) * (ny // fy) * (nz // fz)
    if restrict:
        ccell, par = _cells_of_fine(Mc.col.astype(np.int64), fine_shape, factors)
        r, c = point_cell[Mc.row], ccell
    else:
        rcell, par = _cells_of_fine(Mc.row.astype(np.int64), fine_shape, factors)
        r, c = rcell, point_cell[Mc.col]
    key = par.astype(np.int64) * (2 * ncells + 1) + (c - r + ncells)
    if tail_min:
        _, inv = np.unique(key, return_inverse=True)
        cnt = np.bincount(inv)
        kept = int((cnt >= tail_min).sum())
        return kept if kept else len(cnt)  # all-tail degenerates to keep
    return len(np.unique(key))


def parity_offset_budget_filter(M, point_cell, fine_shape, factors,
                                budget: int):
    """A transfer operator truncated to its `budget` heaviest parity
    diagonals (total over the parity classes); the relocated levels'
    transfer_offset_budget (off by default).

    M: scipy sparse in the build_parity_interp convention, rows the fine
    lattice indices, columns the points (point_cell[j] the cell of point
    j).  Keeps the entries on the budget (parity, offset) diagonals of
    most |value| mass; a row that would lose every entry keeps its
    largest one; kept rows are rescaled to their old row sums, hypre's
    interpolation-truncation semantics (par_interp.c
    hypre_BoomerAMGInterpTruncation).  R is built from the filtered M's
    transpose, so R = P^T stays exact."""
    import scipy.sparse as sp

    Mc = M.tocoo()
    if Mc.nnz == 0:
        return M
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    ncells = (nx // fx) * (ny // fy) * (nz // fz)
    rcell, par = _cells_of_fine(Mc.row.astype(np.int64), fine_shape, factors)
    c = np.asarray(point_cell, dtype=np.int64)[Mc.col]
    key = par.astype(np.int64) * (2 * ncells + 1) + (c - rcell + ncells)
    ukey, inv = np.unique(key, return_inverse=True)
    if budget <= 0 or len(ukey) <= budget:
        return M
    absd = np.abs(Mc.data)
    mass = np.bincount(inv, weights=absd)
    order = np.argsort(-mass, kind="stable")[:budget]
    kept_key = np.zeros(len(ukey), dtype=bool)
    kept_key[order] = True
    keep = kept_key[inv]
    # rows that would empty keep their largest-|value| entry
    n_rows = M.shape[0]
    row_best = np.full(n_rows, -1, dtype=np.int64)
    o = np.argsort(absd, kind="stable")  # ascending: the last write is the max
    row_best[Mc.row[o]] = o
    row_has_kept = np.zeros(n_rows, dtype=bool)
    row_has_kept[Mc.row[keep]] = True
    rescue_rows = np.flatnonzero(~row_has_kept & (row_best >= 0))
    keep[row_best[rescue_rows]] = True
    # row-sum-preserving rescale of the kept entries
    s_old = np.bincount(Mc.row, weights=Mc.data, minlength=n_rows)
    s_new = np.bincount(Mc.row[keep], weights=Mc.data[keep], minlength=n_rows)
    safe = np.abs(s_new) > 1e-12 * np.maximum(np.abs(s_old), 1e-300)
    scale = np.where(safe & (s_new != 0),
                     s_old / np.where(s_new == 0, 1, s_new), 1.0)
    out = sp.csr_matrix(
        (Mc.data[keep] * scale[Mc.row[keep]], (Mc.row[keep], Mc.col[keep])),
        shape=M.shape,
    )
    out.sort_indices()
    return out


def relocate_to_cells(pos, fine_shape, factors, max_load=0.9):
    """Assign each point (fine flat lattice index) a DISTINCT cell of the
    factor-coarsened lattice near its own position (host, deterministic;
    the JAX package's function unchanged).

    This is the setup step that makes algebraically-chosen (PMIS/...)
    coarse grids lattice-regular again: the assignment is a permutation,
    so the relocated coarse operator is similarity-equivalent (identical
    spectrum, identical AMG convergence) while its diagonals become few.

    Collision resolution is displacement-COHERENT: within each (cy, cz)
    row of cells, x-sorted points receive strictly increasing cx via a
    push-right-then-clamp isotonic pass, so nearby points share nearly
    equal displacements and graph-edge cell differences collapse onto
    few diagonals.  Row overflow (points in a cell row exceeding cxn)
    is carried to the next row in (z, y) scan order -- rare at
    load <= max_load for PMIS-style quasi-uniform point sets.

    Returns int64 cells or None if npts > max_load * ncells.
    """
    pos = np.asarray(pos, dtype=np.int64)
    nx, ny, nz = fine_shape
    fx, fy, fz = factors
    cxn, cyn, czn = nx // fx, ny // fy, nz // fz
    ncells = cxn * cyn * czn
    m = len(pos)
    if m > max_load * ncells:
        return None
    ix = pos % nx
    iy = (pos // nx) % ny
    iz = pos // (nx * ny)
    cx = ix // fx
    row = iy // fy + cyn * (iz // fz)  # (cy, cz) flat row id
    nrows = cyn * czn

    # ---- stage 1: carry row overflow along the (z, y) scan ----------
    order = np.lexsort((pos, ix, row))
    counts = np.bincount(row[order], minlength=nrows)
    if counts.max() > cxn:
        idx_by_row = np.split(order, np.cumsum(counts)[:-1])
        carry: list = []
        for r in range(nrows):
            cur = list(idx_by_row[r]) + carry
            carry = []
            if len(cur) > cxn:
                cur.sort(key=lambda i: ix[i])
                over = len(cur) - cxn
                carry = cur[-over:]
                cur = cur[:cxn]
            for i in cur:
                row[i] = r
        if carry:  # wrapped past the last row: nearest row with space
            counts2 = np.bincount(row[np.setdiff1d(order, carry)],
                                  minlength=nrows)
            desired_row = iy // fy + cyn * (iz // fz)
            for i in carry:
                free = np.flatnonzero(counts2 < cxn)
                r = free[np.argmin(np.abs(free - desired_row[i]))]
                row[i] = r
                counts2[r] += 1
        order = np.lexsort((pos, ix, row))
        counts = np.bincount(row[order], minlength=nrows)

    # ---- stage 2: per-row isotonic x assignment ----------------------
    # push-right (a_i = max(a_{i-1} + 1, cx_i) within the row) via a
    # segmented prefix max of (cx_i - rank_i), then clamp from the right
    # so the row fits: a_i <= cxn - m_row + rank_i.  Both bounds are
    # strictly increasing in rank, so the result is a valid distinct
    # in-range assignment whenever m_row <= cxn.
    d = cx[order]
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.arange(m) - np.repeat(starts, counts)
    seg_id = np.repeat(np.arange(nrows), counts)
    BIG = np.int64(1) << 40
    run = np.maximum.accumulate(d - rank + seg_id * BIG)
    a = run - seg_id * BIG + rank
    m_row = np.repeat(counts, counts)
    a = np.minimum(a, cxn - m_row + rank)
    out = np.empty(m, dtype=np.int64)
    out[order] = a + cxn * row[order]
    return out


# ---------------------------------------------------------------------------
# The polymorphic matvec
# ---------------------------------------------------------------------------

def _restrict_launches(A: ParityRestrictOp) -> list:
    """The parity classes a restriction launches K1 for: those with
    diagonals, or the first class alone when only a tail is left."""
    live = [b for b, m in enumerate(A.mats) if m.offsets]
    return live or ([0] if A.tail is not None else [])


def _interp_tails(A: ParityInterpOp) -> tuple:
    return A.class_tails or (None,) * len(A.mats)


def _parity_restrict(A: ParityRestrictOp, x: torch.Tensor) -> torch.Tensor:
    """One strided copy splits x into [B, ncells]; then one K1 launch
    per non-empty parity matrix, chained through K1's axpy form (the JAX
    package sums over the union of offsets instead: another order).  The
    tail (rows = cells, cols = flat fine) rides on the first launch and
    gathers from x itself: it is summed first, where the JAX package
    adds it last."""
    X = parity_split(x, A.fine_shape, A.factors)
    acc = None
    for b in _restrict_launches(A):
        if acc is None:
            acc = dia_spmv(A.mats[b], X[b], tail=(
                None if A.tail is None else A.tail.k1(x)))
        else:
            acc = dia_spmv(A.mats[b], X[b], "axpy", u=acc)
    if acc is None:
        acc = torch.zeros(A.num_rows, dtype=x.dtype, device=x.device)
    return acc


def _parity_interp(A: ParityInterpOp, x: torch.Tensor) -> torch.Tensor:
    """One K1 launch per parity class with diagonals or tail entries
    into a [B, ncells] buffer, each carrying its class's share of the
    tail, then one permuted copy merges it onto the fine lattice."""
    Y = torch.empty(len(A.mats), A.num_cols, dtype=x.dtype, device=x.device)
    for b, (m, t) in enumerate(zip(A.mats, _interp_tails(A))):
        if m.offsets or t is not None:
            dia_spmv(m, x, out=Y[b], tail=None if t is None else t.k1())
        else:
            Y[b].zero_()
    return parity_merge(Y, A.fine_shape, A.factors)


def spmv_tail_after(A, x: torch.Tensor) -> torch.Tensor:
    """A x for a tailed operator (DIAWithTail, ParityRestrictOp,
    ParityInterpOp) as the port ran it before its tails rode in K1: the
    DIA parts through dia_spmv alone, then the whole tail through
    `tail_apply` (`coo_tail` on the card).  The reference the fused
    path is held against; on no solver path."""
    if isinstance(A, DIAWithTail):
        return tail_apply(A.tail, x, dia_spmv(A.dia, x))
    if isinstance(A, ParityRestrictOp):
        X = parity_split(x, A.fine_shape, A.factors)
        y = torch.zeros(A.num_rows, dtype=x.dtype, device=x.device)
        live = [b for b, m in enumerate(A.mats) if m.offsets]
        for k, b in enumerate(live):
            y = (dia_spmv(A.mats[b], X[b]) if k == 0
                 else dia_spmv(A.mats[b], X[b], "axpy", u=y))
    elif isinstance(A, ParityInterpOp):
        Y = torch.zeros(len(A.mats), A.num_cols, dtype=x.dtype, device=x.device)
        for b, m in enumerate(A.mats):
            if m.offsets:
                dia_spmv(m, x, out=Y[b])
        y = parity_merge(Y, A.fine_shape, A.factors)
    else:
        raise TypeError(f"spmv_tail_after: no tail on {type(A).__name__}")
    return y if A.tail is None else tail_apply(A.tail, x, y)


def _matvec(A, x: torch.Tensor) -> torch.Tensor:
    """A x for the operators that have no fused kernel form."""
    if isinstance(A, DenseMatrix):
        return dense_spmv(A, x)
    if isinstance(A, GatherOp):
        return spmv(A.inner, flat_take(x, A.pos))
    if isinstance(A, ScatterOp):
        if A.row_of_cell is not None:
            return cell_dense(A.inner.inner.data, A.inner.pos, A.row_of_cell, x)
        y = spmv(A.inner, x)
        return torch.zeros(A.n_out, dtype=y.dtype, device=y.device
                           ).index_copy_(0, A.pos, y)
    if isinstance(A, ParityRestrictOp):
        return _parity_restrict(A, x)
    if isinstance(A, ParityInterpOp):
        return _parity_interp(A, x)
    raise TypeError(f"spmv: unsupported operator {type(A).__name__}")


def kernel_launches(A) -> dict:
    """{kernel name: launches} of one application of A to a CUDA vector,
    in any form (a form adds torch elementwise ops, never a launch of
    these kernels); "dia_spmv_tail" counts the K1 launches that carry a
    tail (`dia_spmv_cuda.tail_launches`).  No operator launches
    `coo_tail`: every tail rides in K1."""
    if isinstance(A, DIAMatrix):
        return {"dia_spmv": 1}
    if isinstance(A, ELLMatrix):
        return {"ell_spmv": 1}
    if isinstance(A, DenseMatrix):
        return {}
    if isinstance(A, DIAWithTail):
        return {"dia_spmv": 1, "dia_spmv_tail": 1}
    if isinstance(A, ScatterOp):
        if A.row_of_cell is not None:
            return {"cell_dense": 1}
        return kernel_launches(A.inner)
    if isinstance(A, GatherOp):
        inner = kernel_launches(A.inner)
        return {**inner, "flat_take": inner.get("flat_take", 0) + 1}
    if isinstance(A, ParityRestrictOp):
        n = {"dia_spmv": len(_restrict_launches(A))}
        return {**n, "dia_spmv_tail": 1} if A.tail is not None else n
    if isinstance(A, ParityInterpOp):
        tails = _interp_tails(A)
        n = {"dia_spmv": sum(1 for m, t in zip(A.mats, tails)
                             if m.offsets or t is not None)}
        k = sum(1 for t in tails if t is not None)
        return {**n, "dia_spmv_tail": k} if k else n
    raise TypeError(f"kernel_launches: unsupported operator {type(A).__name__}")


def sum_launches(parts) -> dict:
    """{kernel name: launches} of [({kernel name: launches}, times)]."""
    out: dict = {}
    for counts, k in parts:
        for name, c in counts.items():
            out[name] = out.get(name, 0) + k * c
    return out


def _spmv_form(A, x: torch.Tensor, form: str, **operands) -> torch.Tensor:
    if isinstance(A, DIAMatrix):
        return dia_spmv(A, x, form, **operands)
    if isinstance(A, DIAWithTail):
        return dia_spmv(A.dia, x, form, tail=A.tail.k1(), **operands)
    if isinstance(A, ELLMatrix):
        return ell_spmv(A, x, form, **operands)
    return epilogue(form, _matvec(A, x), x, **operands)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Polymorphic matvec over DIA / ELL / dense and the lattice forms
    (DIA with tail, gather, scatter, parity restrict / interp)."""
    return _spmv_form(A, x, "plain")


def spmv_resid(A, x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """f - A x (the residual before restriction)."""
    return _spmv_form(A, x, "resid", f=f)


def spmv_axpy(A, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """u + A x, u of A.num_rows entries (the prolongation u + P e)."""
    return _spmv_form(A, x, "axpy", u=u)


def spmv_jacobi(A, d: torch.Tensor, u: torch.Tensor, f: torch.Tensor,
                w: float) -> torch.Tensor:
    """u + w * d * (f - A u): one weighted Jacobi sweep, d = D^{-1} (or
    the l1 inverse)."""
    return _spmv_form(A, u, "jacobi", f=f, d=d, w=w)
