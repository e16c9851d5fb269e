"""Hand-written CUDA kernels of the port (sources in ../csrc/), one module
per kernel: its ctypes wrapper, its launch counter and its plain PyTorch
version. A wrapper given a CPU tensor runs the plain version; given a CUDA
tensor it launches the kernel or raises."""
