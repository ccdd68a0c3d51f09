"""Comparisons shared by the AMG-family parity tests: host matrices bit
for bit, frozen dense operators bit for bit, BoomerAMG hierarchies and
their lattice gates, and solver results (imports neither jax nor
hypre_tpu; the JAX side's objects are passed in)."""

import importlib.util
import pathlib

import numpy as np
import torch


def same_csr(a, b):
    """Two sparse matrices (either package's CSRMatrix or scipy) bit for
    bit: shape, index arrays and values."""
    a = a.to_scipy() if hasattr(a, "to_scipy") else a.tocsr()
    b = b.to_scipy() if hasattr(b, "to_scipy") else b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data)
            and a.data.dtype == b.data.dtype)


def host(x):
    """numpy of a torch tensor or a jax array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def same_dense(op, jop):
    """A frozen DenseMatrix of the port and the JAX package's, bit for
    bit."""
    assert type(op).__name__ == type(jop).__name__ == "DenseMatrix"
    return np.array_equal(host(op.data), host(jop.data))


def gates(amg):
    """The lattice forms' decisions of a hierarchy (either package)."""
    n0 = amg._host_A[0].shape[0]
    return {"embed_level1": (len(amg.levels) > 1
                             and amg.levels[1].dinv.shape[0] == n0),
            "relocated": sorted(getattr(amg, "_reloc_cells", {}) or {}),
            "frozen_levels": len(amg.levels),
            "setup_levels": len(amg._host_A)}


def same_hierarchy(amg, jamg):
    """A BoomerAMG of the port and one of the JAX package: every level's
    host A, P and CF marker bit for bit, and the same gates."""
    assert gates(amg) == gates(jamg)
    assert len(amg._host_A) == len(jamg._host_A)
    for A, Aj in zip(amg._host_A, jamg._host_A):
        assert same_csr(A, Aj)
    for l in range(len(jamg._host_P)):
        assert same_csr(amg.host_P(l), jamg.host_P(l))
    for cf, cfj in zip(amg._cf, jamg._cf):
        assert np.array_equal(cf, cfj)
    return True


def rel(a, b):
    """max |a - b| / max |b| of two vectors (either package)."""
    a, b = host(a), host(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def same_solve(res, jres, tol=1e-10):
    """The same iteration count and residual history (the same entries
    recorded, each within 1e-10 of the largest), x within tol."""
    its = int(jres.num_iterations)
    assert res.num_iterations == its
    h = host(res.res_norms).astype(np.float64)
    hj = host(jres.res_norms).astype(np.float64)
    assert np.array_equal(np.isnan(h), np.isnan(hj))
    live = ~np.isnan(hj)
    assert np.abs(h[live] - hj[live]).max() <= 1e-10 * np.abs(hj[live]).max()
    assert rel(res.x, jres.x) <= tol
    return its


def chip_smoke():
    """chip_smoke.py as a module (its AUX_* pins)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
