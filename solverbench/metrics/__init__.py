"""One reader a per-layer or end-to-end metric: `read(run)` gives the
number, or None when the run has nothing for it."""
