"""Exchange-correlation functionals.

Mirrors sirius_tpu/dft/xc.py::XCFunctional for the LDA, GGA and SCAN
meta-GGA functionals (XC_LDA_X, XC_LDA_C_PZ, XC_LDA_C_PW, XC_LDA_C_VWN,
XC_GGA_X_PBE, XC_GGA_C_PBE, XC_GGA_X_PBE_SOL, XC_GGA_C_PBE_SOL,
XC_MGGA_X_SCAN, XC_MGGA_C_SCAN), in any sum. Names follow libxc so
reference decks load unchanged. Hartree atomic units.

Two forms:
- evaluate / evaluate_polarized take densities, sigma and tau and return
  the JAX package's dict (e, v or v_up / v_dn, vsigma for GGA and mGGA,
  vtau for mGGA). An LDA sum runs through K7 (kernels/lda_xc.py) on any
  device; a GGA or mGGA sum with sigma is the plain autograd version
  (kernels/xc_functionals.py) and CPU only, because the card evaluates
  them from gradients;
- evaluate_gga / evaluate_gga_polarized (K7g, kernels/gga_xc.py) and
  evaluate_mgga / evaluate_mgga_polarized (K7s, kernels/mgga_xc.py) take
  densities, gradients and (mGGA) tau and return e, v, the flux fields of
  the divergence term and v_tau: the form dft/potential.py runs. A SCAN
  list with LDA or GGA names runs them all in the K7s launch.
"""

from __future__ import annotations

from sirius_tpu_torch.kernels.gga_xc import gga_xc, gga_xc_unpolarized
from sirius_tpu_torch.kernels.lda_xc import lda_xc, lda_xc_unpolarized
from sirius_tpu_torch.kernels.mgga_xc import mgga_xc, mgga_xc_unpolarized
from sirius_tpu_torch.kernels.xc_functionals import (GGA_FUNCS, LDA_FUNCS,
                                                    MGGA_FUNCS, eval_plain,
                                                    func_mask)

SUPPORTED = (*LDA_FUNCS, *GGA_FUNCS, *MGGA_FUNCS)


class XCFunctional:
    """A sum of named LDA, GGA and meta-GGA functionals with exact
    potentials."""

    def __init__(self, names: list[str]):
        unknown = [n for n in names if n not in SUPPORTED]
        if unknown:
            raise ValueError(f"unsupported xc functional(s): {unknown}")
        func_mask(names)  # one kernel launch sums the list: no repeats
        self.names = list(names)
        self.is_mgga = any(n in MGGA_FUNCS for n in names)
        # mGGA needs the full gradient machinery too (xc.py:324-326)
        self.is_gga = self.is_mgga or any(n in GGA_FUNCS for n in names)

    def evaluate_polarized(self, rho_up, rho_dn, sigma_uu=None, sigma_ud=None,
                           sigma_dd=None, tau_up=None, tau_dn=None):
        if not self.is_gga:
            e, vu, vd = lda_xc(rho_up, rho_dn, self.names)
            return {"e": e, "v_up": vu, "v_dn": vd}
        self._plain_only(rho_up)
        e, vu, vd, vsuu, vsud, vsdd, vtu, vtd = eval_plain(
            self.names, rho_up, rho_dn, sigma_uu, sigma_ud, sigma_dd, tau_up,
            tau_dn)
        out = {"e": e, "v_up": vu, "v_dn": vd, "vsigma_uu": vsuu,
               "vsigma_ud": vsud, "vsigma_dd": vsdd}
        if self.is_mgga:
            out.update(vtau_up=vtu, vtau_dn=vtd)
        return out

    def evaluate(self, rho, sigma=None, tau=None):
        """Unpolarized: rho is the total density, sigma = |grad rho|^2, tau
        the total positive kinetic-energy density. Returns e (per volume),
        v = de/drho and, for GGA and mGGA, vsigma = de/dsigma and, for mGGA,
        vtau = de/dtau."""
        if not self.is_gga:
            e, v = lda_xc_unpolarized(rho, self.names)
            return {"e": e, "v": v}
        self._plain_only(rho)
        half = 0.5 * rho
        s4 = None if sigma is None else 0.25 * sigma
        t2 = None if tau is None else 0.5 * tau
        e, vu, vd, vsuu, vsud, vsdd, vtu, vtd = eval_plain(
            self.names, half, half, s4, s4, s4, t2, t2)
        out = {"e": e, "v": 0.5 * (vu + vd),
               "vsigma": 0.25 * (vsuu + vsud + vsdd)}
        if self.is_mgga:
            out["vtau"] = 0.5 * (vtu + vtd)
        return out

    def evaluate_gga_polarized(self, n_up, n_dn, grad_up, grad_dn):
        """(e, v_up, v_dn, flux_up, flux_dn) from the spin densities and the
        gradients [3, N] of the unclipped spin densities (K7g)."""
        return gga_xc(n_up, n_dn, grad_up, grad_dn, self.names)

    def evaluate_gga(self, rho, grad):
        """(e, v, flux) from the total density and its gradient [3, N]
        (K7g)."""
        return gga_xc_unpolarized(rho, grad, self.names)

    def evaluate_mgga_polarized(self, n_up, n_dn, grad_up, grad_dn, tau_up,
                                tau_dn):
        """(e, v_up, v_dn, flux_up, flux_dn, vtau_up, vtau_dn) from the spin
        densities, the gradients [3, N] of the unclipped spin densities and
        the spin kinetic-energy densities (K7s)."""
        return mgga_xc(n_up, n_dn, grad_up, grad_dn, tau_up, tau_dn,
                       self.names)

    def evaluate_mgga(self, rho, grad, tau):
        """(e, v, flux, vtau) from the total density, its gradient [3, N]
        and the total kinetic-energy density (K7s)."""
        return mgga_xc_unpolarized(rho, grad, tau, self.names)

    @staticmethod
    def _plain_only(t):
        if t.device.type != "cpu":
            raise RuntimeError(
                "GGA and mGGA from sigma are the plain version (CPU); on the "
                "card they run from the gradients: evaluate_gga / "
                "evaluate_gga_polarized (K7g), evaluate_mgga / "
                "evaluate_mgga_polarized (K7s)")
