"""One thread for a port test module.

The tier-1 run puts six pytest workers on eight cores.  Each worker's
torch and OpenBLAS keep a thread a core, and those threads spin while
they wait, so the workers take the cores from each other: on an
eight-core x86 CPU a 6^3 multi-box SMG setup (48 small
`np.linalg.pinv`) took 1.9 s alone and 170 s in such a run, and the
port's test files 3,569 test-seconds there against 1,137 with one
thread each.  Every `tests/test_torch_*.py`
imports `one_thread`, an autouse fixture that runs the module's tests
with one torch thread and each loaded BLAS library held to one thread,
and gives both their threads back after them."""

import numpy  # noqa: F401  (loads numpy's BLAS before the limit is set)
import pytest
import scipy.linalg  # noqa: F401  (and scipy's)
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the BLAS limit is a speed-up only
        yield
    else:
        with threadpool_limits(limits=1, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(threads)
