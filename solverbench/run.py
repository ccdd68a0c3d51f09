"""Run one cell of the benchmark once and print its result line.

    python3 -m solverbench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for; without them it exits with code 2 and prints no result.  The
last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 also
`breakdown`, and last `checks`: each number the check compared, with
its limit); the same numbers end standard error.  With --trace 0 the
metrics are the cell's end-to-end metrics, with --trace 1 its per-layer
metrics.  A run that loads JAX or the JAX package exits with code 3 and
prints no result.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """time.time() at which this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


_STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness import forbidden_modules, load_cell, run_cell

    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"solverbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # set-up runs from process start, on the host clock
    t_start = time.perf_counter() - (time.time() - _STARTED)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", t_start=t_start)
    found = forbidden_modules()
    if found:
        print("solverbench: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    out["device"]["power_limit"] = _power_limit()
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


def _power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
