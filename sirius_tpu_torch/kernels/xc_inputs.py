"""K17a: the XC inputs on the fine box (csrc/potential_passes.cu
xc_inputs), and the plain version.

xc_inputs(rho_box, core_r, mag_box, floor) takes the inverse-transformed
rho (and m, collinear) boxes as g_to_r returns them (complex128 [n1, n2,
n3]) and the core charge rho_core_r (float64, or None without one: the
plain version then adds zero) and returns an XcInputs of float64 boxes:
rho_r = Re rho, rho_exc = rho_r + rho_core_r (the exc integrand's density),
rho_xc = clamp(rho_exc, min=floor) (floor 0.0 unpolarized, 1e-20
polarized) and, polarized, mag_r = Re m, m' = min(max(mag_r, -rho_xc),
rho_xc), n_up = 0.5 (rho_xc + m'), n_dn = 0.5 (rho_xc - m'). Every clamp
passes a NaN through, as torch.clamp / maximum / minimum and jnp.maximum /
clip do. Replaces sirius_tpu/dft/potential.py::generate_potential_device
:297-304 and :332. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from sirius_tpu_torch.kernels import build

FLOOR_UNPOLARIZED = 0.0
FLOOR_POLARIZED = 1e-20


@dataclasses.dataclass
class XcInputs:
    rho_r: torch.Tensor
    rho_exc: torch.Tensor
    rho_xc: torch.Tensor
    mag_r: torch.Tensor | None = None
    n_up: torch.Tensor | None = None
    n_dn: torch.Tensor | None = None


def xc_inputs_plain(rho_box, core_r, mag_box, floor: float) -> XcInputs:
    rho_r = rho_box.real
    rho_exc = rho_r + (0.0 if core_r is None else core_r)
    rho_xc = torch.clamp(rho_exc, min=floor)
    out = XcInputs(rho_r.contiguous(), rho_exc, rho_xc)
    if mag_box is not None:
        mag_r = mag_box.real
        m = torch.minimum(torch.maximum(mag_r, -rho_xc), rho_xc)
        out.mag_r = mag_r.contiguous()
        out.n_up = 0.5 * (rho_xc + m)
        out.n_dn = 0.5 * (rho_xc - m)
    return out


def xc_inputs(rho_box, core_r, mag_box, floor: float) -> XcInputs:
    """The XC inputs of the fine box (K17a on a CUDA tensor)."""
    build.check_fields("xc_inputs", torch.complex128, rho_box,
                       ("rho_box", rho_box), ("mag_box", mag_box))
    build.check_fields("xc_inputs", torch.float64, rho_box, ("core_r", core_r))
    if not build.on_cuda(rho_box, "xc_inputs"):
        return xc_inputs_plain(rho_box, core_r, mag_box, floor)
    rho_box, core_r, mag_box = (None if t is None else t.contiguous()
                                for t in (rho_box, core_r, mag_box))
    polarized = mag_box is not None
    f64 = dict(dtype=torch.float64, device=rho_box.device)
    out = XcInputs(*(torch.empty(rho_box.shape, **f64) for _ in range(3)))
    if polarized:
        out.mag_r, out.n_up, out.n_dn = (torch.empty(rho_box.shape, **f64)
                                         for _ in range(3))
    ptr = build.ptr
    rc = build.library("potential_passes").xc_inputs(
        rho_box.data_ptr(), ptr(core_r), ptr(mag_box), float(floor),
        rho_box.numel(), out.rho_r.data_ptr(), out.rho_exc.data_ptr(),
        out.rho_xc.data_ptr(), ptr(out.mag_r), ptr(out.n_up), ptr(out.n_dn),
        build.stream_of(rho_box))
    xc_inputs.launches += 1
    build.check(rc, "xc_inputs")
    return out


xc_inputs.launches = 0
