"""BENCHMARK.json against the benchmark's contract, and each cell's
configuration and traffic found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from solverbench import generator
from solverbench.harness import ROOT, check_module, load_cell, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_json(os.path.join(ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["solverbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        # named cells only: a later cell need not report these
        assert set(m["workloads"]) <= set(WORKLOADS)
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    spec = load_cell(workload)
    cfg, cell = spec["config"], spec["cell"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"solverbench/configs/{cell['config']}.json"
    assert cfg["name"] == cell["config"] and cell["chips"] == 1
    assert entry["reduced"] == cfg["reduced"] and entry["source"] == cfg["source"]
    assert len(cell["why"]) <= 200
    # the line says what the program runs and the reference builds
    line = cfg["line"]
    i = line.index("-n")
    assert [int(v) for v in line[i + 1:i + 4]] == cfg["grid"]
    assert ("-27pt" in line) == cfg["matrix"].endswith("27pt")
    assert cfg["model"] == cfg["matrix"].split(":")[1]
    k, amg = cfg["krylov"], cfg["amg"]
    solver = line[line.index("-solver") + 1]
    assert {"1": "pcg", "3": "gmres"}[solver] == k["call"]
    assert k["reference"] == f"krylov:{k['call']}"
    assert float(line[line.index("-tol") + 1]) == k["kwargs"]["tol"]
    assert int(line[line.index("-max_iter") + 1]) == k["kwargs"]["max_iter"]
    if "-k" in line:
        assert int(line[line.index("-k") + 1]) == k["kwargs"]["k_dim"]
    assert int(line[line.index("-Pmx") + 1]) == amg["P_max"]
    assert {"0": "classical", "6": "ext+i"}[
        line[line.index("-interptype") + 1]] == amg["interp"]
    # the driver's -th and -mxrs defaults, hypre ij's
    assert "-th" not in line and "-mxrs" not in line
    assert (amg["theta"], amg["max_row_sum"]) == (0.25, 1.0)
    if "-rlx" in line:
        assert int(line[line.index("-rlx") + 1]) == amg["relax"][0]
    assert spec["mix"] == generator.load_mix(cell["traffic"])
    # every metric the cell reports has a reader; program, check and
    # loop are found by name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "solverbench", "metrics", f"{m['name']}.py"))
    for sub, name in (("programs", cfg["program"]), ("reference", cfg["check"]),
                      ("loops", spec["mix"]["loop"])):
        assert os.path.exists(os.path.join(ROOT, "solverbench", sub,
                                           f"{name}.py"))
    check = check_module(cfg)
    assert set(cfg["limits"]) == set(check.NUMBERS)
    assert cfg["limits"]["true_res"] == k["kwargs"]["tol"]
    assert callable(check.resolve(cfg["matrix"]))
    assert callable(check.resolve(k["reference"]))


def test_unknown_names_are_refused():
    with pytest.raises(SystemExit):
        load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        generator.load_mix("no_such_mix")


@pytest.mark.parametrize("change", ({"loop": "open"}, {"callers": 2},
                                    {"sample": 0}, {"warm_solves": 1.5}))
def test_mix_parameters_checked(tmp_path, monkeypatch, change):
    """A mix names a loop that exists and gives exactly its parameters,
    each a whole number of at least 1."""
    mix = generator.load_mix("repeat_rhs")
    monkeypatch.setattr(generator, "TRAFFIC_DIR", str(tmp_path))
    (tmp_path / "bad.json").write_text(json.dumps({**mix, **change}))
    with pytest.raises((ValueError, ModuleNotFoundError)):
        generator.load_mix("bad")
