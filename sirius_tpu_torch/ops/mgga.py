"""meta-GGA machinery of the plane-wave path: the kinetic-energy density and
the tau term of the Hamiltonian.

Mirrors sirius_tpu/ops/mgga.py. The mGGA Kohn-Sham operator gains
-1/2 div(v_tau grad .), applied in the plane-wave basis with three more FFT
pairs per band block:

  (H_tau psi)_G = 1/2 sum_c (G+k)_c FFT[ v_tau(r) IFFT[(G+k)_c psi]_r ]_G

and the density side needs tau(r) = 1/2 sum_{k,b} occ_w |grad psi|^2. Per
Cartesian component c: K11a scatters (G+k)_c psi into a zeroed box, cuFFT
transforms it, K1c multiplies by v_tau in place, cuFFT transforms back and
K11b gathers and adds the component into H psi; tau takes K11a, the inverse FFT and K3. The three
components run one after another, so the peak box memory is that of
apply_h_s plus one box block. The preconditioner has no tau term, as in
the JAX package. On the fp32 wave-function path psi is complex64 and
v_tau and the G+k vectors float32 (the JAX package's _gkc_dev(float32),
scf.py:442-448); tau still sums in float64.
"""

from __future__ import annotations

import torch

from sirius_tpu_torch.kernels.density_accumulate import density_accumulate
from sirius_tpu_torch.kernels.mgga_tau import box_to_pw_tau, grad_to_box
from sirius_tpu_torch.kernels.veff_multiply import veff_multiply
from sirius_tpu_torch.ops.hamiltonian import HkParams, apply_h_s
from sirius_tpu_torch.solvers.davidson import davidson


def apply_h_s_mgga(params: HkParams, vtau_r: torch.Tensor, gkc: torch.Tensor,
                   psi: torch.Tensor):
    """(H psi, S psi) including the tau term (ops/mgga.py:32-55). vtau_r:
    [ns, n1, n2, n3] per spin (batch entry b reads vtau_r[b % ns], as
    veff_r); gkc: [B, ngk, 3] or [ngk, 3] Cartesian G+k components; psi
    [B, R, ngk]; vtau_r and gkc of the real type of psi. Counts its
    applications on any device in apply_h_s_mgga.calls."""
    apply_h_s_mgga.calls += 1
    h, s = apply_h_s(params, psi)
    b, r, ngk = psi.shape
    dims = params.dims
    n = dims[0] * dims[1] * dims[2]
    ns = vtau_r.shape[0]
    for c in range(3):
        box = grad_to_box(psi, gkc, c, params.fft_index, params.mask, n)
        fr = torch.fft.ifftn(box.view((b, r) + dims), dim=(-3, -2, -1))
        del box
        veff_multiply(fr.view(b, r, n), vtau_r.view(ns, n))
        vbox = torch.fft.fftn(fr, dim=(-3, -2, -1)).view(b, r, n)
        del fr
        box_to_pw_tau(vbox, gkc, c, params.fft_index, params.mask, h)
        del vbox
    return h, s


apply_h_s_mgga.calls = 0


def tau_kset(params, gkc: torch.Tensor, psi: torch.Tensor,
             occ_w: torch.Tensor) -> torch.Tensor:
    """Coarse-box kinetic-energy density tau(r) = 1/2 sum occ_w |grad psi|^2
    per spin, accumulated k-point by k-point in k order, component by
    component (ops/mgga.py:58-82; the companion of density_kset).

    params: HkSetParams (fft_index, mask [nk, ngk], veff_r for the box
    shape); gkc [nk, ngk, 3]; psi [nk, ns, nb, ngk]; occ_w [nk, ns, nb].
    Returns [ns, n1, n2, n3] float64."""
    nk, ns, nb, ngk = psi.shape
    dims = tuple(params.veff_r.shape[-3:])
    n = dims[0] * dims[1] * dims[2]
    acc = torch.zeros((ns, n), dtype=torch.float64, device=psi.device)
    for ik in range(nk):
        for c in range(3):
            box = grad_to_box(psi[ik], gkc[ik], c, params.fft_index[ik],
                              params.mask[ik], n)
            fr = torch.fft.ifftn(box.view((ns, nb) + dims), dim=(-3, -2, -1))
            del box
            density_accumulate(acc, fr.view(ns, nb, n), occ_w[ik],
                               0.5 * float(n) ** 2)
    return acc.view((ns,) + dims)


def davidson_kset_mgga(params, vtau_r: torch.Tensor, gkc: torch.Tensor, psi,
                       num_steps: int = 20, res_tol: float = 1e-6):
    """davidson_kset with the tau term in the operator (ops/mgga.py:85-136),
    every (k, spin) in one batch. params: HkSetParams; vtau_r [ns, n1, n2,
    n3]; gkc [nk, ngk, 3]; psi [nk, ns, nb, ngk]. The preconditioner
    diagonals are the k-set's own, without a tau term. Returns (evals
    [nk, ns, nb], psi', rnorm [nk, ns, nb])."""
    nk, ns, nb, ngk = psi.shape
    hk = params.hk()
    gkc_b = gkc if ns == 1 else gkc.repeat_interleave(ns, dim=0)

    def apply_fn(p, x):
        return apply_h_s_mgga(p, vtau_r, gkc_b, x)

    ev, x, rn = davidson(
        apply_fn, hk, psi.reshape(nk * ns, nb, ngk),
        params.h_diag.reshape(nk * ns, ngk),
        params.o_diag.repeat_interleave(ns, dim=0), hk.mask,
        num_steps=num_steps, res_tol=res_tol)
    return (ev.reshape(nk, ns, nb), x.reshape(nk, ns, nb, ngk),
            rn.reshape(nk, ns, nb))
