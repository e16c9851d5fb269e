"""K17b: the XC outputs on the fine box (csrc/potential_passes.cu
xc_outputs), and the plain version.

xc_outputs(e, v_up, rho_xc, v_dn=None, div=None) takes the XC kernel's
energy density e and potential v (polarized v_up and v_dn), float64 of
rho_xc's numel, rho_xc itself, and for GGA and mGGA the inverse-transformed
divergence boxes div (complex128 [1, n1, n2, n3] unpolarized, [2, ...]
polarized; their real parts are read), and returns (exc_r, vxc_r, vxc_box,
bz_box) shaped as rho_xc: exc_r = e / clamp(rho_xc, min=1e-25); V_xc = v -
Re div unpolarized, 0.5 (v_up' + v_dn') polarized with v_s' = v_s - Re
div_s, and B_z = 0.5 (v_up' - v_dn'); vxc_r the float64 V_xc (v itself for
unpolarized LDA) and vxc_box, bz_box the complex128 (x, +0) boxes the
forward FFT takes (bz_box None unpolarized). Replaces
sirius_tpu/dft/potential.py::generate_potential_device :318-331 and
:336-346, and r_to_g's cast of those fields. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels import build


def xc_outputs_plain(e, v_up, rho_xc, v_dn=None, div=None):
    shape = rho_xc.shape
    e, v_up = e.view(shape), v_up.view(shape)
    bz_box = None
    if v_dn is None:
        vxc_r = v_up if div is None else v_up - div[0].real
    else:
        v_dn = v_dn.view(shape)
        if div is not None:
            v_up = v_up - div[0].real
            v_dn = v_dn - div[1].real
        vxc_r = 0.5 * (v_up + v_dn)
        bz_box = (0.5 * (v_up - v_dn)).to(torch.complex128)
    exc_r = e / torch.clamp(rho_xc, min=1e-25)
    return exc_r, vxc_r, vxc_r.to(torch.complex128), bz_box


def xc_outputs(e, v_up, rho_xc, v_dn=None, div=None):
    """(exc_r, vxc_r, vxc_box, bz_box) of the XC kernel's outputs (K17b on
    a CUDA tensor)."""
    dev = rho_xc.device
    build.check_fields("xc_outputs", torch.float64, rho_xc, ("e", e),
                       ("v_up", v_up), ("rho_xc", rho_xc), ("v_dn", v_dn),
                       flat=True)
    ns = 1 if v_dn is None else 2
    build.check_fields("xc_outputs", torch.complex128, rho_xc, ("div", div),
                       shape=(ns,) + tuple(rho_xc.shape))
    if not build.on_cuda(rho_xc, "xc_outputs"):
        return xc_outputs_plain(e, v_up, rho_xc, v_dn, div)
    e, v_up, rho_xc, v_dn, div = (None if t is None else t.contiguous()
                                  for t in (e, v_up, rho_xc, v_dn, div))
    shape = rho_xc.shape
    exc = torch.empty(shape, dtype=torch.float64, device=dev)
    # unpolarized LDA: V_xc is v itself, nothing to write
    writes_vxc = not (v_dn is None and div is None)
    vxc_r = (torch.empty(shape, dtype=torch.float64, device=dev)
             if writes_vxc else v_up.view(shape))
    vxc_box = torch.empty(shape, dtype=torch.complex128, device=dev)
    bz_box = None if v_dn is None else torch.empty_like(vxc_box)
    ptr = build.ptr
    rc = build.library("potential_passes").xc_outputs(
        e.data_ptr(), v_up.data_ptr(), ptr(v_dn), ptr(div), rho_xc.data_ptr(),
        rho_xc.numel(), exc.data_ptr(),
        vxc_r.data_ptr() if writes_vxc else None, vxc_box.data_ptr(),
        ptr(bz_box), build.stream_of(rho_xc))
    xc_outputs.launches += 1
    build.check(rc, "xc_outputs")
    return exc, vxc_r, vxc_box, bz_box


xc_outputs.launches = 0
