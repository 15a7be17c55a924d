"""Tensor operations of the port: sorting, kernels, SA-IS and queries."""
