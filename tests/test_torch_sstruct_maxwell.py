"""The port's multi-part Maxwell path — models/maxwell.py's part-local
curl-curl operators, sstruct/shared_dof.py, and
solvers/sstruct_ls/maxwell.py (`pnedelec_interp`, `MaxwellTV`,
`SStructMaxwell`'s three branches) — on the CPU against the JAX
package's, on the same inputs.

  * host structures bitwise: the part operators (ownership-weighted and
    partition-of-unity-weighted), the shared-DOF maps and signs, the
    subassembled global operator, the PNedelec transfers, the TV
    hierarchy (every level's A, G, An, P, R, l1 inverses, the coarse
    pinv);
  * a TV cycle within 1e-12 of the JAX package's on the same vector;
  * each SStructMaxwell branch (parts at `origins` through the TV
    multigrid, rotated parts through `transforms`, block-diagonal parts
    through AMS): the JAX package's count and residual (MAXWELL_RUNS,
    pinned; the slow tier reruns them), x of the TV solve within 1e-12
    live;
  * a fault both packages share, reproduced: two stacked 4^3 parts
    through AMS end in a non-finite residual that PCG calls converged
    (ROADMAP Queue 3; the JAX side in the slow tier).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import maxwell as jm
from hypre_tpu.solvers.sstruct_ls import maxwell as jmx
from hypre_tpu.sstruct import shared_dof as jsd
from hypre_tpu_torch.models import maxwell as pm
from hypre_tpu_torch.solvers.sstruct_ls import maxwell as pmx
from hypre_tpu_torch.sstruct import shared_dof as psd
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
GSHAPE = (8, 4, 4)
PARTS = [(4, 4, 4), (4, 4, 4)]
ORIGINS = [(0, 0, 0), (4, 0, 0)]
TRANSFORMS = [((0, 0, 0), (0, 1, 2), (1, 1, 1)),
              ((8, 4, 0), (0, 1, 2), (-1, -1, 1))]

# branch -> (iterations, final relative residual) of the JAX package,
# b of the TV branches from parts of numpy's default_rng(0), of AMS A @
# default_rng(0) (tests/test_sstruct.py's problem)
MAXWELL_RUNS = {
    "origins": (8, 1.985390923284887e-07),
    "transforms": (8, 1.7544100274412003e-07),
    "ams": (8, 5.76897604696082e-07),
}


def csr_equal(a, b):
    a, b = a.to_scipy() if hasattr(a, "to_scipy") else a, (
        b.to_scipy() if hasattr(b, "to_scipy") else b)
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def test_part_operators_are_the_jax_ones():
    for p, o in zip(PARTS, ORIGINS):
        a = pm.curlcurl_matrix_part(p, o, GSHAPE, 1.0, 0.5)
        b = jm.curlcurl_matrix_part(p, o, GSHAPE, 1.0, 0.5)
        assert csr_equal(a[0], b[0]) and csr_equal(a[1], b[1])
        assert np.array_equal(a[2], b[2])
    wf, we = psd.partition_of_unity_weights(PARTS, TRANSFORMS)
    wfj, wej = jsd.partition_of_unity_weights(PARTS, TRANSFORMS)
    for p, s in enumerate(PARTS):
        assert np.array_equal(wf[p], wfj[p]) and np.array_equal(we[p], wej[p])
        assert csr_equal(pm.curlcurl_matrix_part_weighted(s, wf[p], we[p])[0],
                         jm.curlcurl_matrix_part_weighted(s, wf[p], we[p])[0])


def test_shared_dof_maps_are_the_jax_ones():
    got = psd.shared_node_edge_maps(PARTS, ORIGINS)
    want = jsd.shared_node_edge_maps(PARTS, ORIGINS)
    for a, b in zip(got, want):
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b
    got = psd.shared_node_edge_maps_transformed(PARTS, TRANSFORMS)
    want = jsd.shared_node_edge_maps_transformed(PARTS, TRANSFORMS)
    for a, b in zip(got, want):
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b
    emaps, ne = got[2], got[3]
    canon = psd.canonicalize_edge_maps(emaps, ne, GSHAPE)
    assert all(np.array_equal(x, y) for x, y in zip(
        canon, jsd.canonicalize_edge_maps(emaps, ne, GSHAPE)))
    mats = [pm.curlcurl_matrix_part(p, o, GSHAPE)[0]
            for p, o in zip(PARTS, ORIGINS)]
    _, _, em, ne = psd.shared_node_edge_maps(PARTS, ORIGINS)
    assert csr_equal(psd.subassemble(mats, em, ne),
                     jsd.subassemble(mats, em, ne))
    assert csr_equal(psd.subassemble_signed(mats, emaps, got[4], ne),
                     jsd.subassemble_signed(mats, emaps, got[4], ne))
    with pytest.raises(Exception, match="do not tile"):
        psd.canonicalize_edge_maps(emaps, ne, (8, 4, 5))


def test_pnedelec_is_the_jax_one():
    for a, b in zip(pmx.pnedelec_interp(4, 2, 2), jmx.pnedelec_interp(4, 2, 2)):
        assert csr_equal(a, b)


@pytest.fixture(scope="module")
def tv():
    A = pm.curlcurl_matrix(8, 8, 8)[0]
    Aj = jm.curlcurl_matrix(8, 8, 8)[0]
    opts = dict(tol=1e-8, max_iter=60)
    return (pmx.MaxwellTV((8, 8, 8), A, pmx.MaxwellTVOptions(**opts),
                          device=CPU),
            jmx.MaxwellTV((8, 8, 8), Aj, jmx.MaxwellTVOptions(**opts)))


def test_tv_hierarchy_is_the_jax_one(tv):
    p, j = tv
    assert len(p.levels) == len(j.levels) == 2
    for lp, lj in zip(p.levels, j.levels):
        assert set(lp) - {"l1e", "l1n", "coarse_inv"} >= set(
            k for k in lj if not k.endswith("_f") and k not in
            ("l1e", "l1n", "coarse_inv"))
        for k in ("A", "G", "An", "P", "R"):
            if k in lj:
                assert csr_equal(lp[k], lj[k])
        for k in ("l1e", "l1n", "coarse_inv"):
            if k in lj:
                assert np.array_equal(lp[k].numpy(), np.asarray(lj[k]))


def test_tv_cycle_matches_jax(tv):
    p, j = tv
    f = np.random.default_rng(3).standard_normal(p.levels[0]["A"].num_rows)
    want = np.asarray(j.cycle(jnp.asarray(f)))
    got = p.cycle(torch.from_numpy(f)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_tv_cycle_launches_are_what_a_cycle_runs(monkeypatch):
    """`cycle_launches` against the kernels of the operators one cycle
    multiplies by (16^3: level 0 off the dense path)."""
    from hypre_tpu_torch.ops.dia import kernel_launches, spmv, sum_launches

    tv = pmx.MaxwellTV((16, 16, 16), pm.curlcurl_matrix(16, 16, 16)[0],
                       device=CPU)
    seen = []

    def counted(A, x):
        seen.append((kernel_launches(A), 1))
        return spmv(A, x)

    monkeypatch.setattr(pmx, "spmv", counted)
    tv.cycle(torch.ones(tv.levels[0]["A"].num_rows, dtype=torch.float64))
    want = sum_launches(seen)
    assert want.get("ell_spmv", 0) + want.get("dia_spmv", 0) > 0
    assert tv.cycle_launches() == want


def solve_port(branch):
    if branch == "origins":
        A = [pm.curlcurl_matrix_part(p, o, (16, 8, 8))[0]
             for p, o in zip([(8, 8, 8)] * 2, [(0, 0, 0), (8, 0, 0)])]
        mx = pmx.SStructMaxwell([(8, 8, 8)] * 2, A, origins=[(0, 0, 0),
                                                             (8, 0, 0)],
                                global_shape=(16, 8, 8), device=CPU)
    elif branch == "transforms":
        mx = pmx.SStructMaxwell(
            [(8, 8, 8)] * 2, transforms=[((0, 0, 0), (0, 1, 2), (1, 1, 1)),
                                         ((16, 8, 0), (0, 1, 2),
                                          (-1, -1, 1))], device=CPU)
    else:
        s = (6, 6, 6)
        A1 = pm.curlcurl_matrix(*s)[0]
        mx = pmx.SStructMaxwell([s, s], [A1, A1], device=CPU)
    rng = np.random.default_rng(0)
    if mx.tv is not None:
        return mx, mx.solve_parts([rng.standard_normal(len(m))
                                   for m in mx.edge_maps])
    b = mx.A.to_scipy() @ rng.standard_normal(mx.A.num_rows)
    return mx, mx.solve(torch.from_numpy(b))


def solve_jax(branch):
    if branch == "origins":
        A = [jm.curlcurl_matrix_part(p, o, (16, 8, 8))[0]
             for p, o in zip([(8, 8, 8)] * 2, [(0, 0, 0), (8, 0, 0)])]
        mx = jmx.SStructMaxwell([(8, 8, 8)] * 2, A, origins=[(0, 0, 0),
                                                             (8, 0, 0)],
                                global_shape=(16, 8, 8))
    elif branch == "transforms":
        mx = jmx.SStructMaxwell(
            [(8, 8, 8)] * 2, transforms=[((0, 0, 0), (0, 1, 2), (1, 1, 1)),
                                         ((16, 8, 0), (0, 1, 2),
                                          (-1, -1, 1))])
    else:
        s = (6, 6, 6)
        A1 = jm.curlcurl_matrix(*s)[0]
        mx = jmx.SStructMaxwell([s, s], [A1, A1])
    rng = np.random.default_rng(0)
    if mx.tv is not None:
        return mx, mx.solve_parts([rng.standard_normal(len(m))
                                   for m in mx.edge_maps])
    b = mx.A.to_scipy() @ rng.standard_normal(mx.A.num_rows)
    return mx, mx.solve(jnp.asarray(b))


@pytest.mark.parametrize("branch", sorted(MAXWELL_RUNS))
def test_branch_matches_jax(branch):
    mx, res = solve_port(branch)
    assert (mx.tv is not None) == (branch != "ams")
    iters, rel = MAXWELL_RUNS[branch]
    assert res.converged and res.num_iterations == iters
    assert abs(float(res.rel_residual_norm) - rel) <= 1e-12


def test_origins_branch_matches_live_jax():
    mx, res = solve_port("origins")
    mj, rj = solve_jax("origins")
    assert csr_equal(mx.A, mj.A)
    xj = np.asarray(rj.x)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    assert np.array_equal(mx.part_values(res.x, 1), mj.part_values(rj.x, 1)
                          ) or np.abs(mx.part_values(res.x, 1) - mj.part_values(
                              rj.x, 1)).max() <= 1e-12 * np.abs(xj).max()


def test_stacked_4cube_ams_fault_is_reproduced():
    """Two 4^3 curl-curl parts stacked block-diagonally through AMS: both
    packages end with a non-finite residual and call it converged (the
    same fault: the AMS preconditioner loses definiteness, and PCG's
    energy-norm test reads the negative <r, M r> that follows as below
    tol)."""
    s = (4, 4, 4)
    mx = pmx.SStructMaxwell([s, s], [pm.curlcurl_matrix(*s)[0]] * 2,
                            device=CPU)
    b = mx.A.to_scipy() @ np.random.default_rng(0).standard_normal(
        mx.A.num_rows)
    res = mx.solve(torch.from_numpy(b))
    assert res.converged and not np.isfinite(float(res.rel_residual_norm))


@pytest.mark.slow
def test_jax_stacked_4cube_ams_fault():
    s = (4, 4, 4)
    mj = jmx.SStructMaxwell([s, s], [jm.curlcurl_matrix(*s)[0]] * 2)
    b = mj.A.to_scipy() @ np.random.default_rng(0).standard_normal(
        mj.A.num_rows)
    rj = mj.solve(jnp.asarray(b))
    assert bool(rj.converged) and not np.isfinite(float(rj.rel_residual_norm))


@pytest.mark.slow
@pytest.mark.parametrize("branch", sorted(MAXWELL_RUNS))
def test_jax_branch_matches_its_pin(branch):
    _, res = solve_jax(branch)
    iters, rel = MAXWELL_RUNS[branch]
    assert bool(res.converged) and int(res.num_iterations) == iters
    assert abs(float(res.rel_residual_norm) - rel) <= 1e-12
