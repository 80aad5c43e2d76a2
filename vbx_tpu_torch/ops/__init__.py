"""Compute ops of the port: VB E/M-steps, the structured, dense and
associative-scan forward-backward smoothers, the forward-backward CUDA
kernels with their plain twins, pairwise similarities and score
calibration."""
