"""The roofline's byte counts against a hand count, the same for the
DIA and the ELL form of one operator, and the wavefront counts of the
lexicographic 7- and 27-point grids."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from solverbench import counts
from solverbench.counts import ell, gs, k1
from solverbench.reference.stencil import stencil_matrix


def _dia(A):
    """A's DIA table: one row an offset, zero where the diagonal has no
    entry (the program's layout, ops/dia.py)."""
    C = A.tocoo()
    offs = sorted(set((C.col - C.row).tolist()))
    data = np.zeros((len(offs), A.shape[0]))
    for k, o in enumerate(offs):
        m = (C.col - C.row) == o
        data[k, C.row[m]] = C.data[m]
    return torch.from_numpy(data), tuple(offs)


def _ell(A):
    """A's slot-major ELL table, padded with zeros (ops/csr.py)."""
    lens = np.diff(A.indptr)
    w = lens.max()
    data = np.zeros((w, A.shape[0]))
    cols = np.zeros((w, A.shape[0]), dtype=np.int32)
    for i in range(A.shape[0]):
        s, e = A.indptr[i], A.indptr[i + 1]
        data[:e - s, i] = A.data[s:e]
        cols[:e - s, i] = A.indices[s:e]
    return torch.from_numpy(data), torch.from_numpy(cols)


def test_bytes_hand_count_and_format_independent():
    A = stencil_matrix("7pt", 4, 4, 4)
    # 64 rows: 7 entries each, less one a face neighbour off the grid
    # (6 faces x 16 rows)
    nnz = 64 * 7 - 6 * 16
    assert A.nnz == nnz == 352
    x = torch.ones(64, dtype=torch.float64)
    hand = nnz * 8 + 64 * 8 + 64 * 8  # values, x, y
    data, offs = _dia(A)
    assert data.numel() > nnz  # the DIA table holds zero slots
    got_dia = k1.launch({"data": data, "offsets": offs, "x": x, "f": None,
                         "u": None, "d": None, "tail": None},
                        counts.OperatorCache())["bytes"]
    edata, cols = _ell(A)
    got_ell = ell.launch({"data": edata, "cols": cols, "x": x, "f": None,
                          "u": None, "d": None},
                         counts.OperatorCache())["bytes"]
    assert got_dia == got_ell == hand
    # a fused form adds its vectors: resid reads f, jacobi f and d
    r = k1.launch({"data": data, "offsets": offs, "x": x, "f": x, "u": None,
                   "d": x, "tail": None}, counts.OperatorCache())["bytes"]
    assert r == hand + 2 * 64 * 8


def test_tail_counts_its_entries_once():
    data = torch.zeros(1, 10, dtype=torch.float64)
    data[0, :4] = 2.0
    x = torch.ones(10, dtype=torch.float64)
    tx = torch.ones(1000, dtype=torch.float64)
    vals = torch.tensor([1.0, 0.0, 3.0], dtype=torch.float64)
    got = k1.launch({"data": data, "offsets": (0,), "x": x, "f": None,
                     "u": None, "d": None,
                     "tail": (None, None, vals, tx)},
                    counts.OperatorCache())["bytes"]
    assert got == 4 * 8 + 2 * 8 + 2 * 8 + 2 * 10 * 8


def _csr(A):
    return (torch.from_numpy(A.indptr.astype(np.int32)),
            torch.from_numpy(A.indices.astype(np.int32)),
            torch.from_numpy(A.data))


@pytest.mark.parametrize("stencil,N,expect", [
    ("7pt", 3, 3 * 3 - 2), ("7pt", 5, 3 * 5 - 2), ("7pt", 8, 3 * 8 - 2),
    ("27pt", 3, 7 * 3 - 6), ("27pt", 5, 7 * 5 - 6), ("27pt", 8, 7 * 8 - 6)])
def test_wavefronts_of_lexicographic_grids(stencil, N, expect):
    A = stencil_matrix(stencil, N, N, N)
    indptr, indices, data = _csr(A)
    assert gs.wavefronts(indptr, indices, data, A.shape[0]) == expect


def test_wavefronts_chain_and_diagonal():
    # a diagonal matrix: one wavefront; a lower bidiagonal one: n
    n = 6
    for sub, expect in ((0.0, 1), (-1.0, n)):
        M = np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, sub), -1)
        import scipy.sparse as sp
        A = sp.csr_matrix(M)
        A.eliminate_zeros()
        assert gs.wavefronts(*_csr(A), n) == expect


def test_gs_swept_nonzeros():
    A = stencil_matrix("7pt", 4, 4, 4)
    indptr, indices, data = _csr(A)
    all_rows = torch.arange(64, dtype=torch.int32)
    assert gs.swept_nonzeros(indptr, data, all_rows) == 352
    assert gs.swept_nonzeros(indptr, data, torch.tensor([0], dtype=torch.int32)) == 4


def test_families_found_by_file():
    fams = counts.families()
    assert set(fams) >= {"k1", "ell", "gs"}
    for mod in fams.values():
        assert len(mod.ENTRY) == 2 and mod.KERNEL_NAMES
