"""The port's kernels: CUDA C++ for Hopper (csrc/), with plain versions."""
