"""Small cells for the CPU tests: a workload's spec with its line and
grid cut to a grid the CPU solves in a second."""

from __future__ import annotations

import copy

from solverbench.harness import load_cell

GRIDS = {"laplace7_pcg.repeat_rhs": 20, "laplace27_gmres.repeat_rhs": 14}


def small_spec(workload: str) -> dict:
    spec = copy.deepcopy(load_cell(workload))
    n = GRIDS[workload]
    cfg = spec["config"]
    line = list(cfg["line"])
    i = line.index("-n")
    line[i + 1:i + 4] = [str(n)] * 3
    cfg["line"], cfg["grid"] = line, [n] * 3
    return spec
