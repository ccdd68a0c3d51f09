"""The comparison that decides `correct`, for a BoomerAMG-preconditioned
Krylov solve.

After the window, with the program's device state freed, the benchmark
holds what the timed path produced against the plain reference at the
timed sizes.  The reference builds the fine matrix itself (the
configuration's `matrix` names the builder).  It follows the set-up one
level at a time: from the level matrix A_l (the fine level: its own) it
works out the level's interpolation weights (`interp.py`: strength,
classical or extended+i weights, P_max truncation), taking from the
program only the C / F split and its choice among equal weights, and
holds the program's A_{l+1} to the Galerkin product P^T A_l P of its
weights.  (A coarse operator's entries that are zero in exact
arithmetic come out as rounding noise of either sign, and the sign and
zero tests of strength and interpolation turn such noise into
different weights: so the weights of a level are worked out from the
set-up's own A_l, which `rap_gap` holds to the level above, and not
from a second chain of products.)  The Galerkin hierarchy over the
reference's weights, the V-cycle and the Krylov solve (`amg.py`, and
the configuration's `krylov.reference`) give the reference's answers.

  a0_mismatch    entries in which the program's fine matrix differs
                 from the reference's (exact: limit 0)
  interp_faults  rows of the program's interpolations that break the
                 rules: a C row other than injection, an F row with an
                 entry outside its candidates, more than P_max entries,
                 or a larger weight left out than one kept; a level
                 count that does not fit (exact: limit 0)
  interp_gap     the largest gap between a weight of the program's P
                 and the reference's, over the largest weight of its row
  rap_gap        the largest relative gap, over the coarse levels and a
                 probe vector v drawn from the seed, between the
                 program's A_{l+1} v and P^T A_l P v, P the reference's
                 weights of level l: max |diff| / max (|P^T| |A_l| |P| |v|)
  x_gap          over the window's solves sampled from the seed, the
                 largest ||x - x_ref|| / ||x_ref||, x_ref the reference
                 solve of the same b
  iter_gap       the largest difference of iteration counts there
                 (exact: limit 0)
  true_res       the largest ||b - A x|| / ||b|| of the sampled
                 answers, A the reference's: the configuration's tol

The configuration file gives each limit; `PERF.md` gives the readings
they were set from.
"""

from __future__ import annotations

import importlib

import numpy as np
import scipy.sparse as sp
import torch

from ..generator import PROBE
from . import interp
from .amg import Hierarchy, mv, to_torch_csr, transpose

NUMBERS = ("a0_mismatch", "interp_faults", "interp_gap", "rap_gap", "x_gap",
           "iter_gap", "true_res")


def resolve(name: str):
    """`module:attribute` of the reference package (a later
    configuration names a builder or solver of a file of its own)."""
    module, attr = name.split(":")
    return getattr(importlib.import_module(f"{__package__}.{module}"), attr)


class Reference:
    """The reference for one configuration, in `dtype` on `device`.

    Its fine matrix is the configuration's own.  The interpolation
    weights of level l are worked out here from the set-up's level
    matrix A_l (the fine level: the reference's) on its C / F split,
    taking its choice of columns among equal weights; the hierarchy the
    reference solves with is the Galerkin one over those weights."""

    def __init__(self, cfg: dict, state: dict, *, dtype=torch.float64,
                 device="cpu"):
        self.cfg, self.dtype, self.device = cfg, dtype, torch.device(device)
        self.A0 = resolve(cfg["matrix"])(cfg)
        self.judged = judge_levels(self, state)
        self._judged_state = (id(state["A"]), id(state["P"]))
        Ps = [j.P for j in self.judged]
        self.hier = Hierarchy(
            self.A0, lambda level, A: Ps[level] if level < len(Ps) else None,
            *cfg["amg"]["relax"], dtype=dtype, device=self.device)
        self.A = self.hier.levels[0].A

    def level_matrix(self, state: dict, level: int) -> torch.Tensor:
        """A_level of the set-up, in the reference's dtype on its device
        (the fine level: the reference's own)."""
        A = self.A0 if level == 0 else state["A"][level]
        return to_torch_csr(A, self.dtype, self.device)

    def solve(self, b: torch.Tensor):
        """(x, iterations) of the configuration's Krylov solve of b."""
        k = self.cfg["krylov"]
        A = lambda v: mv(self.A, v)  # noqa: E731
        x, its, _, _ = resolve(k["reference"])(
            A, self.hier.cycle, b.to(self.dtype), **k["kwargs"])
        return x, its

    def interpolations_scipy(self) -> list:
        """The reference's P_l as float64 scipy matrices."""
        return [_scipy(lvl.P) for lvl in self.hier.levels[:-1]]

    def operators_scipy(self) -> list:
        """The reference's A_l as float64 scipy matrices (the control
        hands them over in the program's place)."""
        return [_scipy(A) for A in self.hier.operators()]


def judge_levels(ref: Reference, state: dict) -> list:
    """interp.Judged of each level's P in `state`, against the weights
    worked out from the state's level matrices."""
    amg = ref.cfg["amg"]
    out = []
    for level, (P, cf) in enumerate(zip(state["P"], state["cf"])):
        W = interp.Weights.of(interp.CSR.of(ref.level_matrix(state, level)),
                              cf, amg["interp"], amg["theta"],
                              amg["max_row_sum"])
        out.append(interp.judge(W, P, amg["P_max"]))
    return out


def _scipy(M: torch.Tensor) -> sp.csr_matrix:
    M = M.to("cpu", torch.float64)
    return sp.csr_matrix((M.values().numpy(), M.col_indices().numpy(),
                          M.crow_indices().numpy()), shape=tuple(M.shape))


def verify(ref: Reference, state: dict, samples: list, stream) -> dict:
    """{number: value} of the comparison, on the reference's device.

    ref: the float64 reference.  state: the set-up under judgement: "A"
    its operators by level (scipy), "P" its interpolations, "cf" its
    C / F markers.  samples: (b, x, iterations) of the sampled solves,
    x as the timed path returned it."""
    dt, dev = ref.dtype, ref.device
    out = {}
    prog_A0 = sp.csr_matrix(state["A"][0])
    out["a0_mismatch"] = (int((prog_A0 != ref.A0).nnz)
                          if prog_A0.shape == ref.A0.shape else ref.A0.nnz)
    same = ref.dtype == dt and ref._judged_state == (id(state["A"]),
                                                     id(state["P"]))
    judged = ref.judged if same else judge_levels(ref, state)
    out["interp_faults"] = (sum(j.faults for j in judged)
                            + int(len(state["A"]) != len(state["P"]) + 1))
    out["interp_gap"] = max([j.gap for j in judged], default=0.0)
    # each coarse operator against the Galerkin product of the level
    # above: the set-up's A_l with the reference's P_l
    gaps = [0.0]
    for lvl in range(1, len(state["A"])):
        A_up = ref.level_matrix(state, lvl - 1)
        P = judged[lvl - 1].P.to(dt)
        A_prog = ref.level_matrix(state, lvl)
        v = stream.vector(PROBE, lvl, A_prog.shape[0], dt)
        want = mv(transpose(P), mv(A_up, mv(P, v)))
        scale = float(mv(transpose(P.abs()), mv(A_up.abs(), mv(P.abs(),
                                                               v.abs()))).max())
        gaps.append(float((mv(A_prog, v) - want).abs().max()) / scale)
    out["rap_gap"] = max(gaps)
    x_gap = iter_gap = true_res = 0.0
    for b, x, its in samples:
        b, x = b.to(dt), x.to(dt)
        x_ref, it_ref = ref.solve(b)
        x_gap = max(x_gap, float(torch.linalg.vector_norm(x - x_ref)
                                 / torch.linalg.vector_norm(x_ref)))
        iter_gap = max(iter_gap, abs(int(its) - int(it_ref)))
        true_res = max(true_res, float(
            torch.linalg.vector_norm(b - mv(ref.A, x))
            / torch.linalg.vector_norm(b)))
    out.update(x_gap=x_gap, iter_gap=iter_gap, true_res=true_res)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {number: {value, limit}})."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
