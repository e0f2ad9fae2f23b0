"""Histogram ops of the port: the dispatch and the CUDA kernels."""
