"""The eigenpairs of a batch of Hermitian matrices by cuSOLVER's Jacobi
solver on the card (csrc/eigh_jacobi.cu): the retry of
solvers/davidson.py::_eigh where torch.linalg.eigh, cuSOLVER's divide and
conquer, reports that it failed to converge. cuSOLVER's heevd fails so on
some finite, exactly Hermitian S-subspace matrices of the band solve that
LAPACK solves (ROADMAP queue 3, item 16); the Jacobi rotations converge on
them. A CPU tensor takes torch.linalg.eigh (LAPACK).

eigh_jacobi(a [..., n, n]) returns (evals [..., n] ascending, evecs
[..., n, n] in columns), as torch.linalg.eigh does, for complex128,
complex64, float64 and float32. Counts its CUDA calls in
eigh_jacobi.launches.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build

# the C entry point and eigenvalue type of each matrix type
ENTRY = {torch.complex128: ("eigh_jacobi_c128", torch.float64),
         torch.complex64: ("eigh_jacobi_c64", torch.float32),
         torch.float64: ("eigh_jacobi_f64", torch.float64),
         torch.float32: ("eigh_jacobi_f32", torch.float32)}


def eigh_jacobi(a):
    """(evals, evecs) of the Hermitian batch a, as torch.linalg.eigh."""
    if a.dtype not in ENTRY:
        raise ValueError(f"eigh_jacobi: no entry point for {a.dtype}")
    if a.device.type == "cpu":
        return torch.linalg.eigh(a)
    if a.device.type != "cuda":
        raise RuntimeError(f"eigh_jacobi: unsupported device {a.device}")
    n = a.shape[-1]
    entry, real = ENTRY[a.dtype]
    # cuSOLVER reads the row-major buffer column by column: the transpose,
    # for a Hermitian matrix its conjugate, whose eigenvectors are the
    # conjugates of a's; it writes them column by column, so the buffer
    # read row-major holds their transposes and a's eigenvectors are its
    # conjugate transpose
    buf = a.reshape(-1, n, n).contiguous().clone()
    w = torch.empty(buf.shape[:2], dtype=real, device=a.device)
    info = torch.zeros(buf.shape[0], dtype=torch.int32, device=a.device)
    rc = getattr(build.library("eigh_jacobi"), entry)(
        buf.data_ptr(), w.data_ptr(), n, buf.shape[0], info.data_ptr(),
        build.stream_of(buf))
    eigh_jacobi.launches += 1
    if rc != 0:
        raise RuntimeError(f"{entry}: error {rc} (CUDA, or 1000 + cuSOLVER)")
    bad = int(torch.count_nonzero(info))
    if bad:
        raise torch.linalg.LinAlgError(
            f"{entry}: {bad} of {buf.shape[0]} matrices did not converge")
    return (w.reshape(a.shape[:-1]),
            buf.mH.contiguous().reshape(a.shape))


eigh_jacobi.launches = 0
