"""K18: the elementwise pass of the H preconditioner diagonal
(csrc/h_diag.cu), and the plain version.

h_diag_pass(ekin [nk, ngk], mask [nk, ngk], q [nk, ns, ngk] complex or
None, v0, ns) returns [nk, ns, ngk] float64: mask > 0 ? (ekin + v0) + Re q
: 1e4, with ekin + v0 on every spin where q is None (no projectors). v0 is
Re veff(G = 0), a 0-d tensor on the device (or a float). Replaces the
elementwise half of sirius_tpu/parallel/batched.py::compute_h_diag_device
(:102-116); its projector product stays a cuBLAS product
(parallel/batched.py::compute_h_diag). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def h_diag_pass_plain(ekin, mask, q, v0, ns: int) -> torch.Tensor:
    h = ekin[:, None, :] + v0
    if q is not None:
        h = h + q.real
    else:
        h = h.expand(h.shape[0], ns, h.shape[2])
    return torch.where(mask[:, None, :] > 0, h, 1e4)


def h_diag_pass(ekin, mask, q, v0, ns: int) -> torch.Tensor:
    """mask > 0 ? (ekin + v0) + Re q : 1e4 over [nk, ns, ngk] (K18 on a
    CUDA tensor)."""
    nk, ngk = ekin.shape
    if ekin.dtype != torch.float64 or mask.dtype != torch.float64:
        raise ValueError("ekin and mask must be float64")
    if tuple(mask.shape) != (nk, ngk) or mask.device != ekin.device:
        raise ValueError(f"mask must be [{nk}, {ngk}] on the device of ekin")
    if q is not None and (q.dtype != torch.complex128
                          or tuple(q.shape) != (nk, ns, ngk)
                          or q.device != ekin.device):
        raise ValueError(f"q must be complex128 [{nk}, {ns}, {ngk}] on the "
                         "device of ekin")
    if isinstance(v0, torch.Tensor) and (
            v0.numel() != 1 or v0.dtype != torch.float64
            or v0.device != ekin.device):
        raise ValueError("v0 must be one float64 on the device of ekin")
    if ekin.device.type == "cpu":
        return h_diag_pass_plain(ekin, mask, q, v0, ns)
    if ekin.device.type != "cuda":
        raise RuntimeError(f"h_diag_pass: unsupported device {ekin.device}")
    if not isinstance(v0, torch.Tensor):
        v0 = torch.full((), float(v0), dtype=torch.float64,
                        device=ekin.device)
    out = torch.empty((nk, ns, ngk), dtype=torch.float64, device=ekin.device)
    q = None if q is None else q.contiguous()
    rc = build.library("h_diag").h_diag(
        ekin.contiguous().data_ptr(), mask.contiguous().data_ptr(),
        None if q is None else q.data_ptr(), v0.data_ptr(), nk, ns, ngk,
        out.data_ptr(), build.stream_of(ekin))
    h_diag_pass.launches += 1
    build.check(rc, "h_diag")
    return out


h_diag_pass.launches = 0
