"""sirius_tpu_torch — the PyTorch/CUDA port of sirius_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths and names
(sirius_tpu_torch/dft/scf.py::run_scf mirrors sirius_tpu/dft/scf.py::run_scf).
It imports torch, numpy and scipy, and nothing of JAX or of sirius_tpu.

Tensors are complex128/float64 end to end; the (k, spin) set is an explicit
leading batch axis. The main-path ops that the JAX package leaves to XLA
fusions are hand-written CUDA kernels (sirius_tpu_torch/csrc/, wrappers in
sirius_tpu_torch/kernels/), built from source at first use; FFTs, matrix
products and eigh are cuFFT/cuBLAS/cuSOLVER through torch. Entry points run
on the GPU unless the caller passes device="cpu", where every kernel's plain
PyTorch version runs instead.
"""

__version__ = "0.1.0"
