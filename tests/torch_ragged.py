"""Seeded ragged sparse operators for the port's ELL tests (imports
neither jax nor hypre_tpu)."""

import numpy as np
import scipy.sparse as sp


def ragged(n, m, width, seed):
    """n x m CSR whose rows hold 1..width entries at distinct columns,
    one row holding exactly `width`."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, width + 1, n)
    counts[n // 2] = width
    rows = np.repeat(np.arange(n), counts)
    cols = np.concatenate([rng.choice(m, c, replace=False) for c in counts])
    vals = rng.standard_normal(len(rows))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
