"""hypre_tpu_torch — the PyTorch/CUDA port of hypre_tpu.

First slice: BoomerAMG-preconditioned PCG on the 3D 7-point Poisson
problem (PMIS + classical interpolation + l1-Jacobi, host setup), with
the fine-level DIA SpMV as a hand-written CUDA kernel for Hopper
(`ops/dia_kernel.py`, `csrc/dia_spmv.cu`).  The JAX package `hypre_tpu`
is the reference; this package imports neither it nor jax.

Devices are explicit: every solver and freeze takes `device=`, and no
module picks one by itself.  float32 products never run in TF32: the
two switches below are set off explicitly (the matmul one is off by
default, the cuDNN one is not).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
