"""The benchmark of hypre_tpu_torch, the PyTorch / CUDA port, on an H100.

Run one cell once from the root of a checkout:

    python3 -m solverbench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

The cells, configurations and metrics are named in BENCHMARK.json; each
has its files here, found by name: `configs/<config>.json`, which names
the program's set-up (`programs/<program>.py`), the comparison
(`reference/<check>.py`) and the reference's matrix and Krylov solver;
`traffic/<mix>.json`, which names its load loop (`loops/<loop>.py`,
read by `generator.py`); `metrics/<metric>.py`.  `reference/` is the
plain reference the check holds the program against, `counts/` the frozen byte and wavefront counting of the
rooflines, `peaks.json` the published peaks, `control.py` the readings
the check's limits were set from.  Nothing here imports JAX or the JAX
package.  The CPU tests: `python -m pytest solverbench/tests`.
"""
