"""Measurement tools of the port: `kernel_times.py` (parent against change
on one card) and the hardware experiments `exp_mxu` and `exp_gather`, whose
CUDA sources (`tools/csrc/`) build into a library of their own."""
