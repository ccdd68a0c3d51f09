"""SStruct Maxwell solver (port of hypre_tpu/solvers/sstruct_ls/maxwell.py).

Reference: sstruct_ls/maxwell_{TV_setup,solve,grad,PNedelec}.c (~10
kLoC): an edge-element Maxwell solver on semi-structured grids that
derives the discrete gradient G from the grid TOPOLOGY
(maxwell_grad.c:36: one row per edge, +-1 at the edge's endpoint nodes)
and runs a nodal-auxiliary multigrid on the edge system.

Per part, G and the vertex coordinates come from the part's lattice
(models/maxwell.py edge_structure); inter-part edge identities flow
through the assembled CSR.  Three branches: parts tiling a box at
`origins` (shared edges identified geometrically, sstruct/shared_dof.py,
and subassembled from ownership-weighted part operators), parts placed
by signed-permutation `transforms` (the signed subassembly), or the
block-diagonal parts plus a U coupling.  A factor-2-coarsenable box runs
the PNedelec TV multigrid (`MaxwellTV`), anything else the AMS
auxiliary-space solver.  The setup (the subassembly, the PNedelec
hierarchy, the coarse pinv) runs on the host, the JAX package's
arithmetic; the level operators are frozen by `freeze_auto` onto
`device`, where the cycle and the Krylov loop run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...models.maxwell import edge_structure
from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, kernel_launches, spmv, sum_launches
from ..amg.ams import AMS, AMSOptions
from ..krylov.common import SolverResult


@dataclasses.dataclass
class SStructMaxwellOptions:
    tol: float = 1e-6
    max_iter: int = 200
    ams: AMSOptions = dataclasses.field(default_factory=AMSOptions)


class SStructMaxwell:
    """Edge-element Maxwell on a multi-part lattice grid.

    parts: list of (nx, ny, nz) lattice shapes; A_parts: list of edge
    curl-curl systems per part (CSRMatrix or scipy); inter-part coupling
    via an optional U CSR over the concatenated edge numbering.
    """

    def __init__(
        self,
        parts,
        A_parts=None,
        U=None,
        opts: SStructMaxwellOptions = SStructMaxwellOptions(),
        use_tv: bool | None = None,
        origins=None,
        global_shape=None,
        transforms=None,
        alpha: float = 1.0,
        beta: float = 1.0,
        *,
        device="cuda",
    ):
        """use_tv: run the PNedelec TV multigrid (MaxwellTV below) when
        the problem is a single factor-2-coarsenable part — the
        reference's native Maxwell cycle; defaults to auto.

        origins + global_shape: the parts tile one global box (each
        part's cell box at `origins[p]`); shared edge DOFs on part
        interfaces are identified geometrically (sstruct/shared_dof.py,
        the sstruct_sharedDOFComm.c role) and the global edge system is
        subassembled from the per-part contributions — built with
        ownership weighting (models/maxwell.py curlcurl_matrix_part,
        the maxwell_TV_setup.c parallel-assembly role).  The composed
        system then runs the SAME PNedelec TV multigrid as a
        single-part problem when the global box is factor-2 coarsenable
        — multi-part Maxwell TV.  Other multi-part problems use the AMS
        auxiliary-space path."""
        self.opts = opts
        self.device = torch.device(device)
        self.tv = None
        self.ams = None
        self.edge_maps = None
        self.edge_signs = None
        if transforms is not None:
            # Rotated / mixed-orientation parts (maxwell_PNedelec.c +
            # sstruct_sharedDOFComm.c): signed-permutation transforms
            # place each part in the global frame; edge DOFs whose
            # tangential direction reverses pick up sign -1, and the
            # per-part operators are built with partition-of-unity
            # face/edge weights so the SIGNED subassembly reproduces
            # the single-domain curl-curl exactly.
            from ...models.maxwell import curlcurl_matrix_part_weighted
            from ...sstruct.shared_dof import (
                canonicalize_edge_maps,
                partition_of_unity_weights,
                shared_node_edge_maps_transformed,
                subassemble_signed,
            )

            if A_parts is None:
                wf, we = partition_of_unity_weights(parts, transforms)
                A_parts = [
                    curlcurl_matrix_part_weighted(
                        s, wf[p], we[p], alpha, beta
                    )[0]
                    for p, s in enumerate(parts)
                ]
            nmaps, nn, emaps, ne, signs = (
                shared_node_edge_maps_transformed(parts, transforms)
            )
            if global_shape is None:
                hi = [0, 0, 0]
                for s, (o, c, d) in zip(parts, transforms):
                    for ld in range(3):
                        g = c[ld]
                        hi[g] = max(hi[g], o[g], o[g] + d[ld] * s[ld])
                global_shape = tuple(hi)
            emaps = canonicalize_edge_maps(emaps, ne, global_shape)
            self.edge_maps = emaps
            self.edge_signs = signs
            self.n_edges = ne
            A_glob = subassemble_signed(A_parts, emaps, signs, ne)
            self._init_single(
                tuple(global_shape), CSRMatrix.from_scipy(A_glob), opts,
                use_tv,
            )
            return
        if origins is not None:
            from ...sstruct.shared_dof import (
                canonicalize_edge_maps,
                shared_node_edge_maps,
                subassemble,
            )

            if global_shape is None:
                global_shape = tuple(
                    max(o[d] + s[d] for o, s in zip(origins, parts))
                    for d in range(3)
                )
            nmaps, nn, emaps, ne = shared_node_edge_maps(parts, origins)
            # compose to edge_structure's canonical global numbering so
            # the TV hierarchy (G, An, P from edge_structure on the
            # global box) indexes the SAME ordering as the subassembled
            # operator — identify_dofs numbers by lexicographic key
            emaps = canonicalize_edge_maps(emaps, ne, global_shape)
            self.edge_maps = emaps
            self.n_edges = ne
            A_glob = subassemble(A_parts, emaps, ne)
            self._init_single(
                tuple(global_shape), CSRMatrix.from_scipy(A_glob), opts,
                use_tv,
            )
            return
        if len(parts) == 1 and U is None:
            self._init_single(
                tuple(parts[0]),
                A_parts[0] if isinstance(A_parts[0], CSRMatrix)
                else CSRMatrix.from_scipy(A_parts[0]),
                opts, use_tv,
            )
            return
        Gs, coords, sizes = [], [], []
        for shape in parts:
            G, _C, xyz, ne = edge_structure(*shape)
            Gs.append(G.to_scipy() if hasattr(G, "to_scipy") else G)
            coords.append(xyz)
            sizes.append(ne)
        Gall = sp.block_diag(Gs, format="csr")
        xyz_all = np.vstack(coords)
        Aall = sp.block_diag(
            [a.to_scipy() if hasattr(a, "to_scipy") else a for a in A_parts],
            format="csr",
        )
        if U is not None:
            Aall = (Aall + (U.to_scipy() if hasattr(U, "to_scipy") else U)).tocsr()
        self.A = CSRMatrix.from_scipy(Aall.tocsr())
        self.ams = AMS(self.A, CSRMatrix.from_scipy(Gall), xyz_all, opts.ams,
                       device=self.device)
        self.edge_offsets = np.cumsum([0] + sizes)

    def _init_single(self, shape, A0c: CSRMatrix, opts, use_tv):
        """One (possibly subassembled) box: PNedelec TV multigrid when
        factor-2 coarsenable, AMS auxiliary space otherwise."""
        if use_tv is None:
            use_tv = all(s % 2 == 0 for s in shape)
        self.A = A0c
        if use_tv:
            self.tv = MaxwellTV(
                tuple(shape), A0c,
                MaxwellTVOptions(tol=opts.tol, max_iter=opts.max_iter),
                device=self.device,
            )
            return
        G, _C, xyz, _ne = edge_structure(*shape)
        self.ams = AMS(A0c, G, xyz, opts.ams, device=self.device)

    def solve(self, b, x0=None) -> SolverResult:
        if self.tv is not None:
            return self.tv.solve(b)
        return self.ams.solve(b, tol=self.opts.tol, max_iter=self.opts.max_iter)

    def solve_parts(self, b_parts) -> SolverResult:
        """Solve with per-part right-hand sides (shared-DOF problems):
        b_glob = sum_p S_p^T D_p b_p, the FEM-subassembly convention
        (each part contributes its owned share of a shared edge's load;
        D_p = diag(edge signs) for orientation-flipped parts); the
        scatter runs on the host."""
        from ...sstruct.shared_dof import (
            scatter_to_global,
            scatter_to_global_signed,
        )

        b_parts = [v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                   for v in b_parts]
        if self.edge_signs is not None:
            b = scatter_to_global_signed(
                b_parts, self.edge_maps, self.edge_signs, self.n_edges
            )
        else:
            b = scatter_to_global(b_parts, self.edge_maps, self.n_edges)
        return self.solve(torch.from_numpy(b).to(self.device))

    def part_values(self, x_glob, part: int) -> np.ndarray:
        """Gather a global edge vector back to part `part`'s local
        numbering, on the host (shared DOFs replicate the single global
        value; orientation-flipped local edges read the negated
        circulation)."""
        x = (x_glob.cpu().numpy() if isinstance(x_glob, torch.Tensor)
             else np.asarray(x_glob))
        v = x[self.edge_maps[part]]
        if self.edge_signs is not None:
            v = v * np.asarray(self.edge_signs[part], dtype=v.dtype)
        return v

    def precond(self, r):
        if self.tv is not None:
            return self.tv.cycle(r)
        return self.ams.precond(r)


# ---------------------------------------------------------------------------
# PNedelec edge-element multigrid (maxwell_PNedelec.c + maxwell_TV_setup.c)
# ---------------------------------------------------------------------------

def pnedelec_interp(nx, ny, nz):
    """Lowest-order Nedelec edge prolongation for factor-2 lattice
    coarsening (reference: sstruct_ls/maxwell_PNedelec.c).

    Grid has (nx, ny, nz) CELLS (must be even); edges numbered as in
    models/maxwell.edge_structure (d=0 block, then 1, 2; C-order tails).
    Weights are the de Rham-commuting choice: a d-directed fine edge at
    tail node a contributes to the coarse d-edge at (a_d // 2, transverse
    coarse nodes) with weight (1/2) * prod_t w_t, where w_t = 1 at even
    transverse coordinates and 1/2 to each neighbor at odd ones — so
    G_f @ P_node == P_edge @ G_c EXACTLY (tested), the commutativity
    that makes the coarse edge space a genuine Nedelec space.

    Returns (P_edge, P_node) as scipy CSR.
    """
    NSf = (nx + 1, ny + 1, nz + 1)
    NSc = (nx // 2 + 1, ny // 2 + 1, nz // 2 + 1)

    def node_weights(a):
        """1-D nodal interp: fine coord a -> [(coarse, w), ...]."""
        if a % 2 == 0:
            return [(a // 2, 1.0)]
        return [((a - 1) // 2, 0.5), ((a + 1) // 2, 0.5)]

    # nodal trilinear P
    nidf = np.arange(int(np.prod(NSf))).reshape(NSf)
    nidc = np.arange(int(np.prod(NSc))).reshape(NSc)
    pr, pc, pv = [], [], []
    for a0 in range(NSf[0]):
        for w0 in node_weights(a0):
            for a1 in range(NSf[1]):
                for w1 in node_weights(a1):
                    for a2 in range(NSf[2]):
                        for w2 in node_weights(a2):
                            pr.append(nidf[a0, a1, a2])
                            pc.append(nidc[w0[0], w1[0], w2[0]])
                            pv.append(w0[1] * w1[1] * w2[1])
    P_node = sp.csr_matrix(
        (pv, (pr, pc)), shape=(nidf.size, nidc.size)
    )

    def edge_ids(NS):
        """per-direction edge id offset + tail-grid shapes."""
        shapes = []
        offs = [0]
        for d in range(3):
            shp = list(NS)
            shp[d] -= 1
            shapes.append(tuple(shp))
            offs.append(offs[-1] + int(np.prod(shp)))
        return shapes, offs

    shf, offf = edge_ids(NSf)
    shc, offc = edge_ids(NSc)

    er, ec, ev = [], [], []
    for d in range(3):
        idf = np.arange(int(np.prod(shf[d]))).reshape(shf[d])
        idc = np.arange(int(np.prod(shc[d]))).reshape(shc[d])
        td = [t for t in range(3) if t != d]
        for a in np.ndindex(shf[d]):
            fid = offf[d] + idf[a]
            # along-edge: coarse index a_d // 2, weight 1/2
            base = [0, 0, 0]
            base[d] = a[d] // 2
            combos = [(tuple(base), 0.5)]
            for t in td:
                new = []
                for (idx, w) in combos:
                    for (ct, wt) in node_weights(a[t]):
                        nidx = list(idx)
                        nidx[t] = ct
                        new.append((tuple(nidx), w * wt))
                combos = new
            for idx, w in combos:
                er.append(fid)
                ec.append(offc[d] + idc[idx])
                ev.append(w)
    ne_f, ne_c = offf[-1], offc[-1]
    P_edge = sp.csr_matrix((ev, (er, ec)), shape=(ne_f, ne_c))
    return P_edge, P_node


@dataclasses.dataclass
class MaxwellTVOptions:
    tol: float = 1e-6
    max_iter: int = 200
    num_smooth: int = 2
    num_nodal: int = 2
    max_coarse_edges: int = 600
    relax_weight: float = 0.9


class MaxwellTV:
    """Tangential-vector Maxwell multigrid on a single lattice part:
    PNedelec-coarsened edge hierarchy, each level smoothing edges
    (l1-Jacobi) and correcting in the nodal gradient subspace
    (maxwell_TV_setup.c / maxwell_solve.c structure).  The hierarchy is
    built on the host; every level's A, G, G^T, An, P and R are frozen by
    `freeze_auto` onto `device` with the l1 inverses, and the coarsest
    level's dense pinv goes there too."""

    def __init__(self, shape, A_edge: CSRMatrix,
                 opts: MaxwellTVOptions = MaxwellTVOptions(), *,
                 device="cuda"):
        self.opts = opts
        self.device = dev = torch.device(device)
        self.levels = []
        nx, ny, nz = shape
        A = A_edge.to_scipy().tocsr()
        while True:
            G, _C, _xyz, ne = edge_structure(nx, ny, nz)
            Gs = G.to_scipy() if hasattr(G, "to_scipy") else G
            An = (Gs.T @ A @ Gs).tocsr()
            l1e = np.asarray(np.abs(A).sum(axis=1)).ravel()
            l1n = np.asarray(np.abs(An).sum(axis=1)).ravel()
            lvl = dict(
                A=CSRMatrix.from_scipy(A),
                G=CSRMatrix.from_scipy(Gs),
                An=CSRMatrix.from_scipy(An),
                l1e=np.where(l1e == 0, 0.0, 1.0 / np.where(l1e == 0, 1, l1e)),
                l1n=np.where(l1n == 0, 0.0, 1.0 / np.where(l1n == 0, 1, l1n)),
            )
            can_coarsen = (
                A.shape[0] > opts.max_coarse_edges
                and nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
                and min(nx, ny, nz) >= 2
            )
            if not can_coarsen:
                lvl["coarse_inv"] = np.linalg.pinv(A.toarray(), rcond=1e-12)
                self.levels.append(lvl)
                break
            P_edge, _P_node = pnedelec_interp(nx, ny, nz)
            lvl["P"] = CSRMatrix.from_scipy(P_edge.tocsr())
            lvl["R"] = CSRMatrix.from_scipy(P_edge.T.tocsr())
            self.levels.append(lvl)
            A = (P_edge.T @ A @ P_edge).tocsr()
            nx, ny, nz = nx // 2, ny // 2, nz // 2
        # freeze
        for lvl in self.levels:
            for k in ("A", "G", "An", "P", "R"):
                if k in lvl:
                    lvl[k + "_f"] = freeze_auto(lvl[k], torch.float64, dev)
            lvl["GT_f"] = freeze_auto(
                CSRMatrix.from_scipy(lvl["G"].to_scipy().T.tocsr()),
                torch.float64, dev)
            for k in ("l1e", "l1n", "coarse_inv"):
                if k in lvl:
                    lvl[k] = torch.from_numpy(lvl[k]).to(dev)

    def _smooth(self, lvl, u, f, sweeps):
        o = self.opts
        for _ in range(sweeps):
            u = u + o.relax_weight * lvl["l1e"] * (f - spmv(lvl["A_f"], u))
        return u

    def _nodal_correct(self, lvl, u, f):
        """Gradient-subspace correction: q s.t. An q ~ G^T r, u += G q
        (the ams.c subspace cycle, per level)."""
        o = self.opts
        r = f - spmv(lvl["A_f"], u)
        rn = spmv(lvl["GT_f"], r)
        q = torch.zeros_like(rn)
        for _ in range(o.num_nodal):
            q = q + o.relax_weight * lvl["l1n"] * (rn - spmv(lvl["An_f"], q))
        return u + spmv(lvl["G_f"], q)

    def _cycle(self, l, u, f):
        o = self.opts
        lvl = self.levels[l]
        if "coarse_inv" in lvl:
            return lvl["coarse_inv"] @ f
        u = self._smooth(lvl, u, f, o.num_smooth)
        u = self._nodal_correct(lvl, u, f)
        r = f - spmv(lvl["A_f"], u)
        fc = spmv(lvl["R_f"], r)
        uc = self._cycle(l + 1, torch.zeros_like(fc), fc)
        u = u + spmv(lvl["P_f"], uc)
        u = self._nodal_correct(lvl, u, f)
        u = self._smooth(lvl, u, f, o.num_smooth)
        return u

    def cycle(self, f, u=None):
        u = torch.zeros_like(f) if u is None else u
        return self._cycle(0, u, f)

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    def cycle_launches(self) -> dict:
        """{kernel name: launches} of one `cycle` (ops/dia.py::
        kernel_launches of each matvec it runs)."""
        o = self.opts
        parts = []
        for lvl in self.levels:
            if "coarse_inv" in lvl:
                break
            nodal = [(kernel_launches(lvl["A_f"]), 1),
                     (kernel_launches(lvl["GT_f"]), 1),
                     (kernel_launches(lvl["An_f"]), o.num_nodal),
                     (kernel_launches(lvl["G_f"]), 1)]
            parts += [(kernel_launches(lvl["A_f"]), 2 * o.num_smooth + 1),
                      (kernel_launches(lvl["R_f"]), 1),
                      (kernel_launches(lvl["P_f"]), 1)] + 2 * nodal
        return sum_launches(parts)

    def solve(self, b, x0=None) -> SolverResult:
        from ..krylov import PCGOptions, pcg

        o = self.opts
        return pcg(
            lambda x: spmv(self.levels[0]["A_f"], x), b, M=self.precond,
            opts=PCGOptions(tol=o.tol, max_iter=o.max_iter),
        )
