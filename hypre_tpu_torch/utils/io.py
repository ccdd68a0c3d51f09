"""Matrix/vector I/O in the reference's on-disk formats + hierarchy
checkpointing (port of hypre_tpu/utils/io.py).

Reference: IJ_mv HYPRE_IJMatrixPrint/Read (per-rank files `prefix.00000`
with an "ilower iupper jlower jupper" header then "row col value" lines;
vectors: "ilower iupper" then "index value"), used by ex5.c:225-285 and
the test drivers' -print/-fromfile flags.  Frozen AMG hierarchies are
checkpointed as an npz of per-level CSRs, P's and CF markers plus the
options as JSON, so a solve can restart without redoing setup.

The formats are the JAX package's, byte for byte, and its npz keys: a
file written by either package loads in the other.  Two deliberate
differences in the checkpoint: an AIR hierarchy (restrict_type > 0,
R != P^T) is refused both ways, since the format holds no R (the JAX
package saves one and restores R = P^T); and the loaded options have
their JSON lists back as tuples.
"""

from __future__ import annotations

import dataclasses
import glob
import json

import numpy as np
import scipy.sparse as sp

from ..ops.csr import CSRMatrix


def write_ij_matrix(A: CSRMatrix, prefix: str, rank: int = 0) -> str:
    """HYPRE_IJMatrixPrint format (one shard, 0-based global indices)."""
    path = f"{prefix}.{rank:05d}"
    n, m = A.shape
    with open(path, "w") as f:
        f.write(f"0 {n - 1} 0 {m - 1}\n")
        rows = np.repeat(np.arange(n), A.row_nnz())
        for r, c, v in zip(rows, A.indices, A.data):
            f.write(f"{r} {c} {v:.14e}\n")
    return path


def read_ij_matrix(prefix: str) -> CSRMatrix:
    """Reads all `prefix.NNNNN` rank files (or a single exact path)."""
    files = sorted(glob.glob(f"{prefix}.[0-9]*")) or [prefix]
    rows_l, cols_l, vals_l = [], [], []
    iupper = jupper = 0
    for path in files:
        with open(path) as f:
            hdr = f.readline().split()
            iupper = max(iupper, int(hdr[1]))
            jupper = max(jupper, int(hdr[3]))
            data = np.loadtxt(f, ndmin=2)
        if data.size:
            rows_l.append(data[:, 0].astype(np.int64))
            cols_l.append(data[:, 1].astype(np.int64))
            vals_l.append(data[:, 2])
    return CSRMatrix.from_coo(
        np.concatenate(rows_l),
        np.concatenate(cols_l),
        np.concatenate(vals_l),
        (iupper + 1, jupper + 1),
    )


def write_ij_vector(v: np.ndarray, prefix: str, rank: int = 0) -> str:
    path = f"{prefix}.{rank:05d}"
    v = np.asarray(v)
    with open(path, "w") as f:
        f.write(f"0 {len(v) - 1}\n")
        for i, x in enumerate(v):
            f.write(f"{i} {x:.14e}\n")
    return path


def read_ij_vector(prefix: str) -> np.ndarray:
    files = sorted(glob.glob(f"{prefix}.[0-9]*")) or [prefix]
    n = 0
    chunks = []
    for path in files:
        with open(path) as f:
            hdr = f.readline().split()
            n = max(n, int(hdr[1]) + 1)
            data = np.loadtxt(f, ndmin=2)
        chunks.append(data)
    out = np.zeros(n)
    for data in chunks:
        out[data[:, 0].astype(np.int64)] = data[:, 1]
    return out


# ---------------------------------------------------------------------------
# hierarchy checkpointing
# ---------------------------------------------------------------------------

def _air_refused(what: str) -> ValueError:
    return ValueError(
        f"{what}: an AIR hierarchy (restrict_type > 0) has R != P^T, and "
        f"the checkpoint format holds no R")


def _json_default(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"{type(v).__name__} is not JSON serializable")


def save_amg_hierarchy(amg, path: str) -> None:
    """Persist the host-side hierarchy (CSRs, P's, CF markers, options)."""
    if amg.opts.restrict_type > 0 or any(R is not None for R in amg._host_R):
        raise _air_refused("save_amg_hierarchy")
    arrays = {}
    L = len(amg._host_A)
    for l, M in enumerate(amg._host_A):
        Mc = M.tocsr()
        arrays[f"A{l}_indptr"] = Mc.indptr
        arrays[f"A{l}_indices"] = Mc.indices
        arrays[f"A{l}_data"] = Mc.data
        arrays[f"A{l}_shape"] = np.array(Mc.shape)
    for l in range(L - 1):
        Pc = amg.host_P(l).tocsr()
        arrays[f"P{l}_indptr"] = Pc.indptr
        arrays[f"P{l}_indices"] = Pc.indices
        arrays[f"P{l}_data"] = Pc.data
        arrays[f"P{l}_shape"] = np.array(Pc.shape)
    for l, cf in enumerate(amg._cf):
        arrays[f"cf{l}"] = cf
    arrays["opts_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(amg.opts),
                   default=_json_default).encode(), dtype=np.uint8
    )
    arrays["num_levels"] = np.array(L)
    np.savez_compressed(path, **arrays)


def _tuples(v):
    """JSON's lists back as (nested) tuples."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _options_from_json(text: str):
    """BoomerAMGOptions from a checkpoint's JSON: lists become tuples,
    dof_func an int64 array."""
    from ..solvers.amg.boomeramg import BoomerAMGOptions

    d = {k: _tuples(v) for k, v in json.loads(text).items()}
    if d.get("dof_func") is not None:
        d["dof_func"] = np.asarray(d["dof_func"], dtype=np.int64)
    return BoomerAMGOptions(**d)


def load_amg_hierarchy(path: str, *, device="cuda"):
    """Rebuild a BoomerAMG from a checkpoint, frozen on `device`
    (BoomerAMG.from_host_levels)."""
    from ..solvers.amg.boomeramg import BoomerAMG

    z = np.load(path)
    opts = _options_from_json(bytes(z["opts_json"]).decode())
    if opts.restrict_type > 0:
        raise _air_refused("load_amg_hierarchy")
    L = int(z["num_levels"])

    def csr(key):
        return sp.csr_matrix(
            (z[f"{key}_data"], z[f"{key}_indices"], z[f"{key}_indptr"]),
            shape=tuple(int(s) for s in z[f"{key}_shape"]))

    return BoomerAMG.from_host_levels(
        [csr(f"A{l}") for l in range(L)], [csr(f"P{l}") for l in range(L - 1)],
        [z[f"cf{l}"] for l in range(L)], opts, device=device)
