"""`hypre_tpu_torch.entry.entry(device="cpu")` against the JAX
package's `__graft_entry__.entry()`: the same right-hand side bitwise,
the same hierarchy forms, and one step (at most 10 PCG iterations to
tol 1e-8) agreeing on the relative residual norm within 1e-4 relative
and on x within 1e-5 (float32 vectors: XLA and torch order the
reductions differently)."""

import numpy as np
import torch

import __graft_entry__
from hypre_tpu_torch.entry import entry
from torch_threads import one_thread  # noqa: F401


def test_entry_on_cpu_matches_the_jax_entry():
    jstep, (jb,) = __graft_entry__.entry()
    jx, jr = jstep(jb)
    step, (b,) = entry(device="cpu")
    assert b.device.type == "cpu" and b.dtype == torch.float32
    assert np.array_equal(b.numpy(), np.asarray(jb))
    x, r = step(b)
    jr = float(jr)
    assert 0 < jr < 1e-6  # ten iterations bring it under 1e-6, not 1e-8
    assert abs(float(r) - jr) <= 1e-4 * jr
    assert np.abs(x.numpy() - np.asarray(jx)[:b.shape[0]]).max() <= 1e-5
    # the ext+i lattice hierarchy: embedded L1 from the device RAP, a
    # dense coarse level below it
    forms = [type(lvl.A).__name__ for lvl in step.amg.levels]
    assert forms == ["DIAMatrix", "DIAMatrix", "DenseMatrix"]
    assert step.amg.levels[1].A.data.dtype.itemsize == 2  # bf16
    assert len(step.amg.levels[1].A.offsets) > 57  # wider than classical's

