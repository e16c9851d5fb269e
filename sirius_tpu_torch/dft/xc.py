"""Exchange-correlation functionals.

Mirrors sirius_tpu/dft/xc.py for the functionals of this slice of the port:
XC_LDA_X + XC_LDA_C_PZ, evaluated pointwise by K7 (kernels/lda_xc.py) with
the same libxc-style dead-channel masking. Names follow libxc so reference
decks load unchanged. Hartree atomic units.
"""

from __future__ import annotations

from sirius_tpu_torch.kernels.lda_xc import lda_xc, lda_xc_unpolarized

SUPPORTED = ("XC_LDA_X", "XC_LDA_C_PZ")
# the JAX package's other functionals, which later slices port
_LATER = ("XC_LDA_C_PW", "XC_LDA_C_VWN", "XC_GGA_X_PBE", "XC_GGA_C_PBE",
          "XC_GGA_X_PBE_SOL", "XC_GGA_C_PBE_SOL", "XC_MGGA_X_SCAN",
          "XC_MGGA_C_SCAN")


class XCFunctional:
    """The functional pair X + PZ with closed-form potentials.

    evaluate() operates on flat arrays of density and returns libxc-style
    quantities: e (energy per volume) and v = de/drho (or v_up / v_dn =
    de/dn_sigma from evaluate_polarized).
    """

    def __init__(self, names: list[str]):
        unknown = [n for n in names if n not in SUPPORTED and n not in _LATER]
        if unknown:
            raise ValueError(f"unsupported xc functional(s): {unknown}")
        if sorted(names) != sorted(SUPPORTED):
            raise NotImplementedError(
                f"xc functionals {list(names)}: this port slice evaluates "
                "XC_LDA_X + XC_LDA_C_PZ only; PW/VWN, GGA and polarized XC "
                "come with later slices (ROADMAP queue 1, slice 5; queue 2, "
                "K7 GGA)")
        self.names = list(names)
        self.is_gga = False
        self.is_mgga = False

    def evaluate_polarized(self, rho_up, rho_dn):
        e, vu, vd = lda_xc(rho_up, rho_dn)
        return {"e": e, "v_up": vu, "v_dn": vd}

    def evaluate(self, rho):
        """Unpolarized: rho is the total density. Returns e (per volume) and
        v = de/drho."""
        e, v = lda_xc_unpolarized(rho)
        return {"e": e, "v": v}
