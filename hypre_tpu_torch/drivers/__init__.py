"""The test drivers of the reference (test/ij.c), as command lines:
`python -m hypre_tpu_torch.drivers.ij ...`."""
