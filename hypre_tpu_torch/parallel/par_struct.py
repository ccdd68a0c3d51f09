"""The sharded struct stack (port of hypre_tpu/parallel/par_struct.py;
reference: struct_mv's box distribution, the struct CommPkg ghost
exchanges of struct_communication.c, and the projected coarse boxes of
struct coarsening, hypre_ProjectBox).

The JAX package distributes struct by annotation: it places the vectors
and `A.data` with a `NamedSharding` and GSPMD turns every shifted slice
into a ghost-slab collective-permute.  The port has no partitioner, so
every struct operation that reads a neighbour exchanges explicitly.  One
controller drives S shards (as for ParCSR, mesh.py): a sharded grid
vector is a tuple of per-shard grid blocks, block s on shard s's device,
in row-major order over the process grid.

  * `StructLayout` is the static, host-built plan (the CommPkg analog):
    the global grid shape, which grid axis each mesh axis cuts, and per
    cut axis each process's index range.  A length n cut P ways is the
    JAX package's even split: ceil(n / P) planes a process, the last
    ones short or empty.  `coarsen(axis)` projects a layout onto the
    semicoarsened grid: coarse point k lives on the process that owns
    fine point 2k, so coarse ranges start at ceil(lo / 2), can start
    odd, and can be empty.
  * `StructLayout.ghost` fills r ghost planes on each side of every cut
    axis: one `mesh.ppermute` a direction an axis where every block is
    at least r thick, more where a plane comes from a farther shard
    (thin or empty blocks); axes in mesh order, each over the blocks
    widened by the ghosts of the axes before it, so the corner values of
    (+-1, +-1, .) couplings arrive.  A periodic cut axis wraps; planes
    past a non-periodic edge are zero.
  * `ShardedStructMatrix` holds each shard's coefficients over its block
    widened by the reach of the stencil (the largest |offset| along each
    cut axis), zero on the ghost planes; its product exchanges, runs the
    serial `struct_matvec` on the widened block and keeps the interior,
    so each point sums the serial terms in the serial order.
  * `ShardedSemi` is a semicoarsening transfer (PFMG's and SMG's
    restriction and interpolation) along one axis of a layout: the
    serial transfer on each block, over a window of ghost planes where
    that axis is cut.
  * `ShardedTransfer` is a CSR transfer between two layouts (SparseMSG's
    P and R) as a `ParCSR` (par_csr.py), its rows numbered shard-major
    over the layouts' blocks, each block padded to a common multiple of
    8.

`shard_solver(solver, layout)` puts a struct solver set up serially on
the host (PFMG, SMG, SparseMSG, StructJacobi, StructHybrid) on a
layout: each level is cut to its layout once, at the first use of that
layout.  The solvers read the cut pieces through their level fields and
know nothing of this module.
Nothing gathers a sharded vector onto one device except SMG's plane
solves where its planes are cut (smg.py), which say so.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..solvers.struct_ls.hybrid import StructHybrid
from ..solvers.struct_ls.jacobi import StructJacobi
from ..solvers.struct_ls.pfmg import PFMG, semi_interp_add, semi_restrict
from ..solvers.struct_ls.relax import parity_mask
from ..solvers.struct_ls.smg import SMG, CutPlanes, WholePlanes
from ..solvers.struct_ls.sparse_msg import SparseMSG
from ..struct.matrix import StructMatrix, struct_matvec
from ..utils.errors import arg_error
from .mesh import AXIS, Mesh, ppermute
from .par_csr import ParCSR
from .partition import BlockPartition

def _tuple(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def even_ranges(n: int, parts: int) -> tuple:
    """The JAX package's even split of n over `parts`: ceil(n / parts)
    each, the last ones short or empty."""
    c = -(-n // parts)
    return tuple((min(p * c, n), min((p + 1) * c, n)) for p in range(parts))


@dataclasses.dataclass(frozen=True)
class StructLayout:
    """Where each shard's block of a grid lies (module docstring).

    gaxes[k] is the grid axis that mesh axis k cuts (-1: none, only for
    a mesh axis of size 1); ranges[k][p] the (lo, hi) of process p along
    mesh axis k; periodic the grid's periodic flags."""

    mesh: object
    shape: tuple
    gaxes: tuple
    ranges: tuple
    periodic: tuple
    # the ghost exchange's plans, built once each, like a CommPkg
    _plans: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False, hash=False)

    @classmethod
    def even(cls, mesh, shape, axis_name=AXIS, grid_axis=0,
             periodic=None) -> "StructLayout":
        """The layout of a grid of `shape` cut along `grid_axis` by the
        mesh axes `axis_name` (tuples for a process grid), evenly."""
        names = tuple(mesh.shape)
        axes, gax = _tuple(axis_name), _tuple(grid_axis)
        if len(axes) != len(gax):
            raise arg_error(f"axis names {axes} against grid axes {gax}")
        if len(set(gax)) != len(gax) or not all(0 <= g < len(shape)
                                                  for g in gax):
            raise arg_error(f"grid axes {gax} for a grid of {len(shape)} axes")
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise arg_error(f"mesh axes {unknown} not in the mesh's {names}")
        cut = dict(zip(axes, gax))
        gaxes, ranges = [], []
        for name, size in mesh.shape.items():
            if name not in cut:
                if size > 1:
                    raise arg_error(
                        f"mesh axis {name!r} ({size} shards) cuts no grid "
                        "axis; a replicated struct block is not supported")
                gaxes.append(-1)
                ranges.append(((0, 0),))
                continue
            gaxes.append(cut[name])
            ranges.append(even_ranges(shape[cut[name]], size))
        periodic = tuple(periodic) if periodic else (0,) * len(shape)
        return cls(mesh, tuple(int(s) for s in shape), tuple(gaxes),
                   tuple(ranges), tuple(int(p) for p in periodic))

    # -- geometry ------------------------------------------------------
    @property
    def dims(self) -> tuple:
        return tuple(self.mesh.shape.values())

    @property
    def size(self) -> int:
        return len(self.mesh.devices)

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    def coords(self, s: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(s, self.dims))

    def box(self, s: int) -> tuple:
        """((lo, hi) per grid axis) of shard s's block."""
        box = [(0, n) for n in self.shape]
        for k, c in enumerate(self.coords(s)):
            if self.gaxes[k] >= 0:
                box[self.gaxes[k]] = self.ranges[k][c]
        return tuple(box)

    def block_shape(self, s: int) -> tuple:
        return tuple(hi - lo for lo, hi in self.box(s))

    def slices(self, s: int) -> tuple:
        return tuple(slice(lo, hi) for lo, hi in self.box(s))

    def cut_axes(self) -> tuple:
        return tuple(g for g in self.gaxes if g >= 0)

    def coarsen(self, axis: int) -> "StructLayout":
        """The layout of the grid semicoarsened along `axis` ((n + 1) // 2
        points): hypre's projection, coarse k on the owner of fine 2k."""
        shape = list(self.shape)
        shape[axis] = (shape[axis] + 1) // 2
        ranges = tuple(
            tuple(((lo + 1) // 2, (hi + 1) // 2) for lo, hi in r)
            if g == axis else r for g, r in zip(self.gaxes, self.ranges))
        return dataclasses.replace(self, shape=tuple(shape), ranges=ranges)

    # -- placing and bringing back ---------------------------------------
    def from_host(self, a) -> tuple:
        """A host array (or tensor) of the grid's shape as its S blocks,
        block s on shard s's device."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[self.slices(s)]))
                     .to(dev) for s, dev in enumerate(self.devices))

    def to_host(self, blocks) -> np.ndarray:
        """The blocks put back together as one host array."""
        parts = [b.detach().cpu().numpy() for b in blocks]
        out = np.zeros(self.shape, dtype=parts[0].dtype)
        for s, part in enumerate(parts):
            out[self.slices(s)] = part
        return out

    def gather(self, blocks) -> dict:
        """The whole grid on each distinct device of the shards ({device:
        tensor}): the blocks moved there and put together, the process
        grid's last axis innermost (an all-gather)."""
        out = {}
        for dev in dict.fromkeys(b.device for b in blocks):
            moved = [b if b.device == dev else b.to(dev, non_blocking=True)
                     for b in blocks]

            def join(k, at):
                if k == len(self.dims):
                    return moved[int(np.ravel_multi_index(at, self.dims))]
                parts = [join(k + 1, at + (p,)) for p in range(self.dims[k])]
                return (parts[0] if self.gaxes[k] < 0
                        else torch.cat(parts, dim=self.gaxes[k]))

            out[dev] = join(0, ())
        return out

    # -- the ghost exchange --------------------------------------------
    def _axis_plan(self, k: int, r: int, wrap: bool) -> tuple:
        """For mesh axis k and reach r: per shard, the pieces of its lower
        and upper ghost ((src shard, src lo, count) or (None, None,
        count) for zeros), and the rounds: {(side, distance, n): [(src,
        dst, src lo, count)]}, each round a permutation."""
        ax, rng = self.gaxes[k], self.ranges[k]
        n, P = self.shape[ax], len(rng)
        owner = np.full(n, -1)
        for p, (lo, hi) in enumerate(rng):
            owner[lo:hi] = p
        dims = self.dims
        pieces, rounds = [], {}
        for s in range(self.size):
            c = list(self.coords(s))
            lo, hi = rng[c[k]]
            sides = []
            for side, planes in ((0, range(lo - r, lo)), (1, range(hi, hi + r))):
                segs = []  # [src process or None, first plane, count]
                for q in planes:
                    if wrap:
                        q %= n
                    elif q < 0 or q >= n:
                        q = None
                    p = None if q is None else int(owner[q])
                    if segs and segs[-1][0] == p and (
                            p is None or segs[-1][1] + segs[-1][2] == q):
                        segs[-1][2] += 1
                    else:
                        segs.append([p, q, 1])
                out = []
                for seq, (p, q, m) in enumerate(segs):
                    if p is None:
                        out.append((None, None, m))
                        continue
                    src_c = list(c)
                    src_c[k] = p
                    src = int(np.ravel_multi_index(src_c, dims))
                    out.append((src, q - rng[p][0], m))
                    key = (side, (p - c[k]) % P, seq)
                    rounds.setdefault(key, []).append((src, s, q - rng[p][0], m))
                sides.append(out)
            pieces.append(sides)
        return pieces, rounds

    def ghost(self, blocks, reach, wrap=None) -> list:
        """Each block widened by reach[g] ghost planes on both sides of
        every cut grid axis g (module docstring).  `wrap` per grid axis
        (default: the periodic flags)."""
        wrap = self.periodic if wrap is None else wrap
        out = list(blocks)
        for k, ax in enumerate(self.gaxes):
            if ax < 0 or not reach[ax]:
                continue
            key = (k, int(reach[ax]), bool(wrap[ax]))
            if key not in self._plans:
                self._plans[key] = self._axis_plan(*key)
            pieces, rounds = self._plans[key]
            got = {}
            for (side, _, _), moves in sorted(rounds.items()):
                sends = [out[s].narrow(ax, 0, 0) for s in range(self.size)]
                for src, _, a, m in moves:
                    sends[src] = out[src].narrow(ax, a, m)
                recv = ppermute(sends, [(src, dst) for src, dst, _, _ in moves])
                for src, dst, a, m in moves:
                    got[(dst, side, src, a)] = recv[dst]
            widened = []
            for s, x in enumerate(out):
                parts = []
                for side in (0, 1):
                    for src, a, m in pieces[s][side]:
                        if src is None:
                            shp = list(x.shape)
                            shp[ax] = m
                            parts.append(x.new_zeros(shp))
                        else:
                            parts.append(got[(s, side, src, a)])
                    if side == 0:
                        parts.append(x)
                widened.append(torch.cat(parts, dim=ax))
            out = widened
        return out

    def interior(self, s: int, widened: torch.Tensor, reach) -> torch.Tensor:
        """The block's own points of a widened block."""
        sl = [slice(None)] * widened.dim()
        for ax in self.cut_axes():
            if reach[ax]:
                n = widened.shape[ax] - 2 * reach[ax]
                sl[ax] = slice(reach[ax], reach[ax] + n)
        return widened[tuple(sl)]


def vector_sharding(mesh, ndim: int, axis_name=AXIS, grid_axis=0):
    """The placement of an `ndim`-axis grid vector (the JAX package's
    NamedSharding): a StructSharding whose `layout(shape)` is the
    StructLayout of a grid of that shape."""
    axes, gax = _tuple(axis_name), _tuple(grid_axis)
    if any(g >= ndim for g in gax):
        raise arg_error(f"grid axes {gax} for {ndim}-axis vectors")
    return StructSharding(mesh, ndim, axes, gax)


@dataclasses.dataclass(frozen=True)
class StructSharding:
    mesh: object
    ndim: int
    axis_name: tuple
    grid_axis: tuple

    def layout(self, shape, periodic=None) -> StructLayout:
        if len(shape) != self.ndim:
            raise arg_error(f"a {len(shape)}-axis grid for a {self.ndim}-axis "
                            "sharding")
        return StructLayout.even(self.mesh, tuple(shape), self.axis_name,
                                 self.grid_axis, periodic)


# ---------------------------------------------------------------------------
# the sharded matrix
# ---------------------------------------------------------------------------

def stencil_reach(A: StructMatrix) -> tuple:
    """The largest |offset| along each grid axis."""
    offs = A.all_offsets
    return tuple(max((abs(o[d]) for o in offs), default=0)
                 for d in range(len(A.shape)))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStructMatrix:
    """A StructMatrix cut to a layout (module docstring): `blocks[s]` is
    shard s's StructMatrix over its block widened by `reach` along the
    cut axes (coefficients zero on the ghost planes, the cut axes not
    periodic: their ghosts carry the wrap)."""

    layout: StructLayout
    blocks: tuple
    reach: tuple

    @property
    def shape(self) -> tuple:
        return self.layout.shape

    def matvec(self, x, alpha=1.0, beta=0.0, y=None) -> tuple:
        """y = alpha A x + beta y on the blocks: the ghost exchange, the
        serial product on each widened block, its interior."""
        lay = self.layout
        xg = lay.ghost(x, self.reach)
        out = []
        for s, (B, xs) in enumerate(zip(self.blocks, xg)):
            acc = lay.interior(s, struct_matvec(B, xs), self.reach).contiguous()
            if alpha != 1.0:
                acc = alpha * acc
            if y is not None and beta != 0.0:
                acc = acc + beta * y[s]
            out.append(acc)
        return tuple(out)


def shard_matrix(A: StructMatrix, layout: StructLayout) -> ShardedStructMatrix:
    """A (on any device) cut to `layout`: each shard's widened block of
    A.data on its device, the constant entries as they are."""
    if tuple(A.shape) != layout.shape:
        raise arg_error(f"a {tuple(A.shape)} matrix on a {layout.shape} layout")
    reach = stencil_reach(A)
    data = A.data.detach().cpu().numpy()
    periodic = tuple(A.periodic or (0,) * len(A.shape))
    local_periodic = tuple(0 if d in layout.cut_axes() else p
                           for d, p in enumerate(periodic))
    blocks = []
    for s, dev in enumerate(layout.devices):
        box = layout.box(s)
        wide = [hi - lo for lo, hi in box]
        src, dst = [slice(None)], [slice(None)]
        for d, (lo, hi) in enumerate(box):
            r = reach[d] if d in layout.cut_axes() else 0
            wide[d] += 2 * r
            src.append(slice(lo, hi))
            dst.append(slice(r, r + hi - lo))
        blk = np.zeros((data.shape[0], *wide), dtype=data.dtype)
        blk[tuple(dst)] = data[tuple(src)]
        blocks.append(dataclasses.replace(
            A, data=torch.from_numpy(blk).to(dev), periodic=local_periodic,
            _shape=tuple(wide)))
    return ShardedStructMatrix(
        layout=dataclasses.replace(layout, periodic=periodic),
        blocks=tuple(blocks), reach=reach)


def shard_struct(A: StructMatrix, x_arrays, mesh, axis_name=AXIS,
                 grid_axis=0):
    """Place a StructMatrix and vectors on the mesh, cut along one or
    several grid axes (tuples of mesh axis names and grid axes for a
    process grid from make_mesh_nd).  Returns (A_sharded, [x blocks]);
    `A_sharded.layout` places and brings back further vectors."""
    lay = StructLayout.even(mesh, tuple(A.shape), axis_name, grid_axis,
                            A.periodic)
    A_sh = shard_matrix(A, lay)
    return A_sh, [A_sh.layout.from_host(v) for v in x_arrays]


# ---------------------------------------------------------------------------
# the transfers
# ---------------------------------------------------------------------------

class ShardedSemi:
    """The semicoarsening transfer along `axis` between `layout` and
    `layout.coarsen(axis)`, with the serial transfer's weights p_lo /
    p_hi (tensors at the odd fine points): pfmg.semi_restrict and
    pfmg.semi_interp_add on each block.  Where `axis` is cut, a shard
    owning the fine planes [a, b) and the coarse [ka, kb) runs them on a
    window that starts at an even global plane, with the weights cut to
    the window's odd planes (zero past the grid), and keeps its own
    planes:
      * restriction on the fine planes [2 ka - 2, 2 kb) (the fine block
        with two ghost planes each side), dropping the window's first
        coarse point;
      * interpolation of the coarse planes [a // 2, b // 2 + 1) (the
        coarse block with one ghost plane each side) into a zero window
        over the fine planes [2 (a // 2), 2 (b // 2) + 1), whose planes
        [a, b) are added to x.
    Planes past the grid are zero and nothing wraps, as in the serial
    transfers, so an owned point's sum is the serial one, its terms in
    the serial order (a point at the grid's edge adds an exact zero)."""

    def __init__(self, layout: StructLayout, axis: int, p_lo, p_hi):
        self.fine, self.axis = layout, axis
        self.coarse = layout.coarsen(axis)
        self.cut = axis in layout.cut_axes()
        p_lo, p_hi = p_lo.cpu().numpy(), p_hi.cpu().numpy()
        no = p_lo.shape[axis]
        nd = len(layout.shape)
        self.wrap = (0,) * nd
        self.shards = []
        for s, dev in enumerate(layout.devices):
            box = layout.box(s)

            def cut_w(w, k0, k1):
                """w over the odd planes [k0, k1) along `axis` (zero
                past the grid's) and the block on the other axes."""
                sl = [slice(lo, hi) for lo, hi in box]
                sl[axis] = slice(max(k0, 0), min(k1, no))
                pad = [(0, 0)] * nd
                pad[axis] = (max(0, -k0), max(0, k1 - max(k0, no)))
                return torch.from_numpy(np.pad(w[tuple(sl)], pad)).to(dev)

            if not self.cut:
                self.shards.append(dict(r=(cut_w(p_lo, 0, no),
                                           cut_w(p_hi, 0, no))))
                continue
            a, b = box[axis]
            ka, kb, c0, c1 = (a + 1) // 2, (b + 1) // 2, a // 2, b // 2 + 1
            self.shards.append(dict(
                r=(cut_w(p_lo, ka - 1, kb), cut_w(p_hi, ka - 1, kb)),
                r_win=(2 * ka - a, 2 * (kb - ka + 1)), nc=kb - ka,
                i=(cut_w(p_lo, c0, c1 - 1), cut_w(p_hi, c0, c1 - 1)),
                i_win=(c0 - ka + 1, c1 - c0), own=(a - 2 * c0, b - a)))
        self.fine_reach = tuple(2 * (d == axis) for d in range(nd))
        self.coarse_reach = tuple(int(d == axis) for d in range(nd))

    def restrict(self, r) -> tuple:
        """b_c = P^T r (semi_restrict) on the blocks."""
        ax = self.axis
        if not self.cut:
            return tuple(semi_restrict(rs, ax, *w["r"])
                         for rs, w in zip(r, self.shards))
        rg = self.fine.ghost(r, self.fine_reach, self.wrap)  # [a - 2, b + 2)
        return tuple(
            semi_restrict(g.narrow(ax, *w["r_win"]), ax, *w["r"])
            .narrow(ax, 1, w["nc"]).contiguous()
            for g, w in zip(rg, self.shards))

    def interp_add(self, x, e_c) -> tuple:
        """x += P e_c (semi_interp_add) on the blocks, in place."""
        ax = self.axis
        if not self.cut:
            return tuple(semi_interp_add(xs, ax, *w["r"], es)
                         for xs, es, w in zip(x, e_c, self.shards))
        eg = self.coarse.ghost(e_c, self.coarse_reach, self.wrap)  # [ka - 1, kb + 1)
        for xs, g, w in zip(x, eg, self.shards):
            e = g.narrow(ax, *w["i_win"])
            shp = list(xs.shape)
            shp[ax] = 2 * e.shape[ax] - 1
            dx = semi_interp_add(xs.new_zeros(shp), ax, *w["i"], e)
            xs += dx.narrow(ax, *w["own"])
        return tuple(x)


class ShardedTransfer:
    """A host CSR operator from the grid of `layout_in` to that of
    `layout_out` as a ParCSR (par_csr.py): rows and columns renumbered
    shard-major (shard s's block points in row-major order from s x
    per), each block padded to `per` (the largest block, rounded up to a
    multiple of 8), so a product is ParCSR's halo exchange and one ELL
    launch a shard; `matvec` takes and returns grid blocks."""

    def __init__(self, M, layout_out: StructLayout, layout_in: StructLayout,
                 dtype=np.float64):
        M = sp.csr_matrix(M)
        self.lay_out, self.lay_in = layout_out, layout_in
        self.per_out, pos_out = _shard_major(layout_out)
        self.per_in, pos_in = _shard_major(layout_in)
        S = layout_in.size
        C = M.tocoo()
        R = sp.csr_matrix((C.data, (pos_out[C.row], pos_in[C.col])),
                          shape=(S * self.per_out, S * self.per_in))
        R.sort_indices()
        blocks = [R[s * self.per_out:(s + 1) * self.per_out] for s in range(S)]
        self.mesh = Mesh(devices=layout_in.devices)
        self.par = ParCSR.from_row_blocks(
            blocks, R.shape, self.mesh,
            col_part=BlockPartition(S * self.per_in, S, self.per_in),
            dtype=dtype)

    def matvec(self, x) -> tuple:
        flat = []
        for s, xs in enumerate(x):
            v = xs.reshape(-1)
            pad = self.per_in - v.numel()
            flat.append(torch.cat([v, v.new_zeros(pad)]) if pad else v)
        y = self.par.matvec(flat)
        return tuple(ys[: int(np.prod(self.lay_out.block_shape(s)))]
                     .reshape(self.lay_out.block_shape(s))
                     for s, ys in enumerate(y))

    def kernel_launches(self) -> dict:
        """One ELL launch a shard a product."""
        return self.par.kernel_launches()


def _shard_major(lay: StructLayout):
    """(per, pos): the padded block length and each global point's index
    in the shard-major numbering."""
    sizes = [int(np.prod(lay.block_shape(s))) for s in range(lay.size)]
    per = max(8, -(-max(sizes) // 8) * 8)
    ids = np.arange(int(np.prod(lay.shape))).reshape(lay.shape)
    pos = np.empty(ids.size, dtype=np.int64)
    for s in range(lay.size):
        blk = ids[lay.slices(s)].reshape(-1)
        pos[blk] = s * per + np.arange(blk.size)
    return per, pos


# ---------------------------------------------------------------------------
# the struct solvers on a layout
# ---------------------------------------------------------------------------

def shard_solver(solver, layout: StructLayout):
    """A struct solver set up serially (PFMG, SMG, SparseMSG,
    StructJacobi, StructHybrid) on the sharded grid of `layout`: a
    shallow copy with its operators and level data cut to the layout
    (each coarse level's the fine one projected, `StructLayout.coarsen`),
    whose `solve`, `cycle` and `precond` take and return tuples of grid
    blocks.  Made once a layout and kept on the solver."""
    made = solver.__dict__.setdefault("_on", {})
    if layout not in made:
        cut = _CUTS.get(type(solver))
        if cut is None:
            raise arg_error(f"{type(solver).__name__} has no sharded form")
        new = copy.copy(solver)
        new.layout, new._on = layout, {}
        cut(solver, new, layout)
        made[layout] = new
    return made[layout]


def _cut_pfmg(pf: PFMG, new, layout) -> None:
    """Each level's operator, inverse diagonal, red mask (from each
    block's global origin) and transfer cut to its layout."""
    new.levels, lay = [], layout
    for lvl in pf.levels:
        red = None
        if lvl.red_mask is not None:
            red = tuple(parity_mask(lay.block_shape(s), 0, device=d,
                                    origin=[lo for lo, _ in lay.box(s)])
                        for s, d in enumerate(lay.devices))
        xfer = None
        if lvl.cdir >= 0:
            xfer = ShardedSemi(lay, lvl.cdir, lvl.p_lo, lvl.p_hi)
        new.levels.append(dataclasses.replace(
            lvl, A=shard_matrix(lvl.A, lay), dinv=lay.from_host(lvl.dinv),
            red_mask=red, p_lo=None, p_hi=None, xfer=xfer))
        if lvl.cdir >= 0:
            lay = lay.coarsen(lvl.cdir)


def _cut_smg(smg: SMG, new, layout) -> None:
    """Each level's operator, plane solves (smg.py: whole planes where
    the last axis is cut, gathered ones where it is not) and transfer cut
    to its layout."""
    new.levels, lay = [], layout
    for lvl in smg.levels:
        a = lvl.cdir
        planes = (WholePlanes(lvl.planes, lay, a) if a in lay.cut_axes()
                  else CutPlanes(lvl.planes, lay, a, smg.device))
        xfer = None
        if lvl.p_lo is not None:
            xfer = ShardedSemi(lay, a, lvl.p_lo, lvl.p_hi)
        new.levels.append(dataclasses.replace(
            lvl, A=shard_matrix(lvl.A, lay), planes=planes, p_lo=None,
            p_hi=None, xfer=xfer))
        if lvl.p_lo is not None:
            lay = lay.coarsen(a)


def _cut_sparse_msg(msg: SparseMSG, new, layout) -> None:
    """Each grid's operator, inverse diagonal and visit weights cut to
    its layout (the fine one projected along each direction the grid was
    coarsened), each P and R a ShardedTransfer between two layouts."""
    lays = {}
    for g in msg.keys:
        lay = layout
        for d, k in enumerate(g):
            for _ in range(k):
                lay = lay.coarsen(d)
        lays[g] = lay
    new.grids = {g: shard_matrix(A, lays[g]) for g, A in msg.grids.items()}
    new.dinv = {g: lays[g].from_host(v) for g, v in msg.dinv.items()}
    new.visit = {g: tuple(lays[g].from_host(w) for w in v)
                 for g, v in msg.visit.items()}
    new.Rdev, new.Pdev = {}, {}
    for (g, d), (P, _) in msg.Pmat.items():
        child = msg._edge(g, d)
        new.Pdev[(g, d)] = ShardedTransfer(P, lays[g], lays[child])
        new.Rdev[(g, d)] = ShardedTransfer(P.T.tocsr(), lays[child], lays[g])


def _cut_jacobi(jac: StructJacobi, new, layout) -> None:
    new.A = shard_matrix(jac.A, layout)
    new.dinv = layout.from_host(jac.dinv)


def _cut_hybrid(hyb: StructHybrid, new, layout) -> None:
    """The DSCG phase's operator and diagonal cut; phase 2's PFMG is set
    up serially on the switch and cut to the same layout."""
    new.dscg, new._pfmg = None, None
    new.A = shard_matrix(hyb.A, layout)
    new._dinv = layout.from_host(hyb._dinv)
    new._build_pfmg = lambda: shard_solver(PFMG(hyb.A, hyb.opts.pfmg), layout)


_CUTS = {PFMG: _cut_pfmg, SMG: _cut_smg, SparseMSG: _cut_sparse_msg,
         StructJacobi: _cut_jacobi, StructHybrid: _cut_hybrid}
