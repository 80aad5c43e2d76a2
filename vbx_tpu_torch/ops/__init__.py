"""Compute ops of the port: VB E/M-steps, the structured scaled
forward-backward smoother, the fused forward-backward CUDA kernel with its
plain twin, pairwise similarities and score calibration."""
