"""Exchange-correlation functionals.

Mirrors sirius_tpu/dft/xc.py::XCFunctional for the LDA and GGA functionals
(XC_LDA_X, XC_LDA_C_PZ, XC_LDA_C_PW, XC_LDA_C_VWN, XC_GGA_X_PBE,
XC_GGA_C_PBE, XC_GGA_X_PBE_SOL, XC_GGA_C_PBE_SOL), in any sum. Names follow
libxc so reference decks load unchanged. Hartree atomic units.

Two forms:
- evaluate / evaluate_polarized take densities and sigma and return the
  JAX package's dict (e, v or v_up / v_dn, and vsigma for GGA). An LDA sum
  runs through K7 (kernels/lda_xc.py) on any device; a GGA sum with sigma
  is the plain autograd version (kernels/xc_functionals.py) and CPU only,
  because the card evaluates GGA from gradients;
- evaluate_gga / evaluate_gga_polarized take densities and gradients and
  return e, v and the flux fields of the divergence term through K7g
  (kernels/gga_xc.py): the form dft/potential.py runs.
"""

from __future__ import annotations

from sirius_tpu_torch.kernels.gga_xc import gga_xc, gga_xc_unpolarized
from sirius_tpu_torch.kernels.lda_xc import lda_xc, lda_xc_unpolarized
from sirius_tpu_torch.kernels.xc_functionals import (GGA_FUNCS, LDA_FUNCS,
                                                    eval_plain, func_mask)

SUPPORTED = (*LDA_FUNCS, *GGA_FUNCS)
# the JAX package's meta-GGA functionals, which a later slice ports
_LATER = ("XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN")


class XCFunctional:
    """A sum of named LDA and GGA functionals with exact potentials."""

    def __init__(self, names: list[str]):
        unknown = [n for n in names if n not in SUPPORTED and n not in _LATER]
        if unknown:
            raise ValueError(f"unsupported xc functional(s): {unknown}")
        if any(n in _LATER for n in names):
            raise NotImplementedError(
                f"xc functionals {list(names)}: SCAN (meta-GGA) needs the "
                "kinetic-energy density and comes with ROADMAP queue 1, "
                "slice 10 (K7 SCAN)")
        func_mask(names)  # one kernel launch sums the list: no repeats
        self.names = list(names)
        self.is_mgga = False
        self.is_gga = any(n in GGA_FUNCS for n in names)

    def evaluate_polarized(self, rho_up, rho_dn, sigma_uu=None, sigma_ud=None,
                           sigma_dd=None):
        if not self.is_gga:
            e, vu, vd = lda_xc(rho_up, rho_dn, self.names)
            return {"e": e, "v_up": vu, "v_dn": vd}
        self._plain_only(rho_up)
        e, vu, vd, vsuu, vsud, vsdd = eval_plain(
            self.names, rho_up, rho_dn, sigma_uu, sigma_ud, sigma_dd)
        return {"e": e, "v_up": vu, "v_dn": vd, "vsigma_uu": vsuu,
                "vsigma_ud": vsud, "vsigma_dd": vsdd}

    def evaluate(self, rho, sigma=None):
        """Unpolarized: rho is the total density, sigma = |grad rho|^2.
        Returns e (per volume), v = de/drho and, for GGA,
        vsigma = de/dsigma."""
        if not self.is_gga:
            e, v = lda_xc_unpolarized(rho, self.names)
            return {"e": e, "v": v}
        self._plain_only(rho)
        half = 0.5 * rho
        s4 = None if sigma is None else 0.25 * sigma
        e, vu, vd, vsuu, vsud, vsdd = eval_plain(self.names, half, half, s4,
                                                 s4, s4)
        return {"e": e, "v": 0.5 * (vu + vd),
                "vsigma": 0.25 * (vsuu + vsud + vsdd)}

    def evaluate_gga_polarized(self, n_up, n_dn, grad_up, grad_dn):
        """(e, v_up, v_dn, flux_up, flux_dn) from the spin densities and the
        gradients [3, N] of the unclipped spin densities (K7g)."""
        return gga_xc(n_up, n_dn, grad_up, grad_dn, self.names)

    def evaluate_gga(self, rho, grad):
        """(e, v, flux) from the total density and its gradient [3, N]
        (K7g)."""
        return gga_xc_unpolarized(rho, grad, self.names)

    @staticmethod
    def _plain_only(t):
        if t.device.type != "cpu":
            raise RuntimeError(
                "GGA from sigma is the plain version (CPU); on the card GGA "
                "runs from the gradients: evaluate_gga / "
                "evaluate_gga_polarized (K7g)")
