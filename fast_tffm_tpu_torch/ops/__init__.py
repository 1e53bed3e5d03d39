"""Scoring math and the CUDA kernels behind it."""
