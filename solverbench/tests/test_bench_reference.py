"""The plain reference on tiny systems: the stencil matrices, the
strength graph and interpolation weights against hand counts and
against the program, the V-cycle and the two Krylov solvers against a
direct solve."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from solverbench.reference import interp, krylov
from solverbench.reference.amg import Hierarchy, mv, to_torch_csr
from solverbench.reference.stencil import stencil_matrix


def test_stencil_rows():
    A = stencil_matrix("7pt", 3, 3, 3)
    centre = 13  # (1, 1, 1)
    assert A[centre, centre] == 6 and A[centre].nnz == 7
    assert A[0, 0] == 6 and A[0].nnz == 4  # a corner: 3 neighbours
    B = stencil_matrix("27pt", 3, 3, 3)
    assert B[centre, centre] == 26 and B[centre].nnz == 27
    assert B[0].nnz == 8 and (B[0].data[B[0].indices != 0] == -1).all()
    assert (A != A.T).nnz == 0 and (B != B.T).nnz == 0


def _two_level(n):
    """A 1D-aggregation P for the tiny tests: pairs of rows."""
    rows = np.arange(n)
    return sp.csr_matrix((np.ones(n), (rows, rows // 2)),
                         shape=(n, (n + 1) // 2))


def _fixed(Ps, dtype=torch.float64):
    """make_P of a hierarchy over the given interpolations."""
    return lambda level, A: (to_torch_csr(Ps[level], dtype, "cpu")
                             if level < len(Ps) else None)


def _exact(A, b):
    return spla.spsolve(A.tocsc(), b)


def test_pcg_with_l1_jacobi_cycle_solves():
    A = stencil_matrix("7pt", 6, 6, 6)
    n = A.shape[0]
    P0 = _two_level(n)
    P1 = _two_level(P0.shape[1])
    H = Hierarchy(A, _fixed([P0, P1]), 18, 18, dtype=torch.float64, device="cpu")
    assert [lvl.A.shape[0] for lvl in H.levels] == [n, n // 2, n // 4]
    # the Galerkin product
    Ac = (P0.T @ A @ P0).toarray()
    assert np.allclose(H.levels[1].A.to_dense().numpy(), Ac)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n))
    At = to_torch_csr(A, torch.float64, "cpu")
    x, its, conv, rel = krylov.pcg(lambda v: mv(At, v), H.cycle, b, 1e-10, 200)
    assert conv and rel < 1e-10 and 0 < its < 200
    assert np.allclose(x.numpy(), _exact(A, b.numpy()), rtol=1e-7, atol=1e-9)


def test_gmres_with_gauss_seidel_cycle_solves():
    A = stencil_matrix("27pt", 5, 5, 5)
    n = A.shape[0]
    H = Hierarchy(A, _fixed([_two_level(n)]), 13, 14, dtype=torch.float64,
                  device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    At = to_torch_csr(A, torch.float64, "cpu")
    x, its, conv, rel = krylov.gmres(lambda v: mv(At, v), H.cycle, b, 1e-10,
                                     200, 5)
    assert conv and rel <= 1e-10
    assert np.allclose(x.numpy(), _exact(A, b.numpy()), rtol=1e-7, atol=1e-9)


def test_gauss_seidel_sweeps_in_row_order():
    A = stencil_matrix("7pt", 3, 3, 2)
    n = A.shape[0]
    H = Hierarchy(A, _fixed([_two_level(n)]), 13, 14, dtype=torch.float64,
                  device="cpu")
    f = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    u0 = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    D = A.toarray()
    fwd, bwd = u0.numpy().copy(), u0.numpy().copy()
    for i in range(n):
        fwd[i] = (f[i].item() - D[i] @ fwd + D[i, i] * fwd[i]) / D[i, i]
    for i in reversed(range(n)):
        bwd[i] = (f[i].item() - D[i] @ bwd + D[i, i] * bwd[i]) / D[i, i]
    lvl = H.levels[0]
    assert np.allclose(H._relax(lvl, 13, u0, f).numpy(), fwd)
    assert np.allclose(H._relax(lvl, 14, u0, f).numpy(), bwd)


def test_float32_reference_is_float32():
    A = stencil_matrix("7pt", 4, 4, 4)
    H = Hierarchy(A, _fixed([_two_level(64)], torch.float32), 18, 18,
                  dtype=torch.float32,
                  device="cpu")
    assert all(lvl.A.dtype == torch.float32 for lvl in H.levels)
    assert H.cycle(torch.ones(64)).dtype == torch.float32


def _csr_of(A, dtype=torch.float64):
    return interp.CSR.of(to_torch_csr(A, dtype, "cpu"))


def test_strength_by_hand():
    # row 0: diag 4, off -2, -0.4, +1: min -2, theta 0.25 -> a < -0.5
    A = sp.csr_matrix(np.array([[4.0, -2.0, -0.4, 1.0],
                                [-2.0, 4.0, 0.0, 0.0],
                                [-0.4, 0.0, -4.0, 3.0],
                                [1.0, 0.0, 3.0, 4.0]]))
    A.eliminate_zeros()
    M = _csr_of(A)
    s = interp.strength(M, 0.25, 1.0)
    got = {(int(r), int(c)) for r, c in zip(M.rows[s], M.cols[s])}
    # row 2 has a negative diagonal: strong where a > 0.25 * max(0, 3)
    # row 3: min(0, 1, 3) = 0, so nothing is below it
    assert got == {(0, 1), (1, 0), (2, 3)}


@pytest.mark.parametrize("kind", interp.KINDS)
def test_weights_by_hand_1d(kind):
    """The 1D Laplacian with every other point C: an F point takes 1/2
    from each C neighbour, by either interpolation."""
    n = 7
    A = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    cf = np.where(np.arange(n) % 2 == 0, 1, -1)
    W = interp.Weights.of(_csr_of(A), cf, kind, 0.25, 1.0)
    got = sp.csr_matrix((W.vals.numpy(), (W.rows.numpy(), W.cols.numpy())),
                        shape=(n, 4)).toarray()
    want = np.zeros((n, 4))
    for i in (1, 3, 5):
        want[i, i // 2] = want[i, i // 2 + 1] = 0.5
    assert np.allclose(got, want, atol=1e-15)


def test_classical_strong_f_neighbour_by_hand():
    """F point 1 with C neighbour 0 and strong F neighbour 2, which
    hangs on C points 0 and 3: the share of a_12 goes to 0 alone (3 is
    not a candidate of 1); extended+i takes 3 in as a candidate."""
    A = sp.csr_matrix(np.array([[4.0, -1.0, -1.0, 0.0],
                                [-1.0, 4.0, -2.0, 0.0],
                                [-1.0, -2.0, 4.0, -1.0],
                                [0.0, 0.0, -1.0, 4.0]]))
    A.eliminate_zeros()
    cf = np.array([1, -1, -1, 1])
    W = interp.Weights.of(_csr_of(A), cf, "classical", 0.25, 1.0)
    row1 = {int(c): float(v) for r, c, v in zip(W.rows, W.cols, W.vals)
            if r == 1}
    # w_10 = a_10 + a_12 * a_20 / a_20 = -1 - 2; d = 4
    assert row1 == {0: pytest.approx(3 / 4, abs=1e-15)}
    W = interp.Weights.of(_csr_of(A), cf, "ext+i", 0.25, 1.0)
    row1 = {int(c): float(v) for r, c, v in zip(W.rows, W.cols, W.vals)
            if r == 1}
    # s_12 = a_20 + a_23 + a_21 = -4; w_10 = -1 + (-2 / -4)(-1),
    # w_13 = (-2 / -4)(-1); d = 4 + (-2 / -4)(-2)
    assert row1 == {0: pytest.approx(1.5 / 3, abs=1e-15),
                    1: pytest.approx(0.5 / 3, abs=1e-15)}


@pytest.mark.parametrize("workload", ("laplace7_pcg.repeat_rhs",
                                      "laplace27_gmres.repeat_rhs"))
def test_weights_match_the_program(workload):
    """At a small grid the reference's weights, on the program's split,
    are the program's to rounding on every level; a P with one weight
    moved, one row's columns swapped for a smaller weight, or a C row
    spoilt is judged at fault."""
    from solverbench.harness import setup
    from solverbench.reference.amg import galerkin, transpose
    from solverbench.tests._small import small_spec

    spec = small_spec(workload)
    amg = spec["config"]["amg"]
    program, _ = setup(spec, torch.device("cpu"))
    state = program.host_state()
    A = to_torch_csr(state["A"][0], torch.float64, "cpu")
    for P_prog, cf in zip(state["P"], state["cf"]):
        W = interp.Weights.of(interp.CSR.of(A), cf, amg["interp"],
                              amg["theta"], amg["max_row_sum"])
        j = interp.judge(W, P_prog, amg["P_max"])
        assert j.faults == 0 and j.gap < 1e-13
        A = galerkin(A, j.P, transpose(j.P))
    W = interp.Weights.of(_csr_of(state["A"][0]), state["cf"][0],
                          amg["interp"], amg["theta"], amg["max_row_sum"])
    P = state["P"][0].tocsr(copy=True)
    lens = np.diff(P.indptr)
    f_row = int(np.flatnonzero(lens > 1)[0])
    moved = P.copy()
    moved.data[P.indptr[f_row]] *= 1 + 1e-9
    j = interp.judge(W, moved, amg["P_max"])
    assert j.faults == 0 and j.gap > 1e-10
    c_row = int(np.flatnonzero(np.asarray(state["cf"][0]) > 0)[0])
    spoilt = P.copy()
    spoilt.data[P.indptr[c_row]] = 0.5
    assert interp.judge(W, spoilt, amg["P_max"]).faults == 1
    # a truncated row that keeps one weight fewer than P_max, and one
    # that keeps a candidate more
    full = sp.csr_matrix((W.vals.numpy(), (W.rows.numpy(), W.cols.numpy())),
                         shape=P.shape)
    i = next(i for i in range(P.shape[0])
             if full.indptr[i + 1] - full.indptr[i] > lens[i] == amg["P_max"])
    fewer = P.tolil()
    fewer[i, fewer.rows[i][0]] = 0
    fewer = fewer.tocsr()
    fewer.eliminate_zeros()
    assert interp.judge(W, fewer, amg["P_max"]).faults == 1
    more = P.tolil()
    extra = next(int(c) for c in full[i].indices if c not in more.rows[i])
    more[i, extra] = full[i, extra]
    assert interp.judge(W, more.tocsr(), amg["P_max"]).faults == 1


@pytest.mark.parametrize("kind", interp.KINDS)
def test_weights_do_not_depend_on_the_blocks(kind, monkeypatch):
    A = _csr_of(stencil_matrix("27pt", 9, 8, 7))
    cf = np.where(np.random.default_rng(4).random(A.n) < 0.3, 1, -1)
    whole = interp.weights(A, torch.as_tensor(cf), kind, 0.25, 1.0)
    monkeypatch.setattr(interp, "BLOCK_TRIPLES", 997)
    assert len(interp._blocks(torch.full((A.n,), 300))) > 100
    parts = interp.weights(A, torch.as_tensor(cf), kind, 0.25, 1.0)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
