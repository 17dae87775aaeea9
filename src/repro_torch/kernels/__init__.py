"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with a
plain PyTorch version beside its wrapper. A wrapper given a CPU tensor runs
the plain version; given any other tensor it launches the kernel or raises."""
