"""Radial grids, splines, and radial integrals.

Replaces the reference's src/radial/ (radial_grid.hpp, spline.hpp,
radial_integrals.hpp:27-439). Pseudopotential radial functions live on
non-uniform (log-like) grids from the species files; all integrals are done
host-side in numpy at setup via exact piecewise-cubic-spline quadrature, and
G-space quantities are tabulated on a uniform q-grid then interpolated at the
|G| shell values (the reference's Radial_integrals_* splined-f(q) scheme).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.special import spherical_jn


@dataclasses.dataclass(frozen=True)
class RadialGrid:
    """A non-uniform radial grid r_0 < r_1 < ... (bohr)."""

    r: np.ndarray

    @staticmethod
    def exponential(rmin: float, rmax: float, n: int) -> "RadialGrid":
        return RadialGrid(r=np.geomspace(rmin, rmax, n))

    @property
    def num_points(self) -> int:
        return len(self.r)

    def __len__(self) -> int:
        return len(self.r)


class Spline:
    """Natural cubic spline of f on a radial grid with exact integration.

    Mirrors the reference Spline (src/radial/spline.hpp): interpolation +
    integrate(m) = int f(r) r^m dr over the grid support.
    """

    def __init__(self, grid: RadialGrid | np.ndarray, values: np.ndarray):
        self.r = grid.r if isinstance(grid, RadialGrid) else np.asarray(grid)
        self.values = np.asarray(values, dtype=np.float64)
        self._cs = CubicSpline(self.r, self.values, bc_type="not-a-knot")

    def __call__(self, x):
        return self._cs(x)

    def derivative(self, x, nu: int = 1):
        return self._cs(x, nu=nu)

    def integrate(self, m: int = 0) -> float:
        """int_{r0}^{rN} f(r) r^m dr, exact for the spline representation.

        For m > 0 the product (piecewise cubic) * r^m is integrated exactly by
        Gauss-Legendre of sufficient order on each interval.
        """
        if m == 0:
            return float(self._cs.antiderivative()(self.r[-1]) - self._cs.antiderivative()(self.r[0]))
        # degree 3 + m polynomial per interval -> n = ceil((4+m)/2) GL points
        npts = (4 + m + 1) // 2 + 1
        x, w = np.polynomial.legendre.leggauss(npts)
        a, b = self.r[:-1], self.r[1:]
        mid, half = 0.5 * (a + b), 0.5 * (b - a)
        pts = mid[:, None] + half[:, None] * x[None, :]
        vals = self._cs(pts) * pts**m
        return float(np.sum(half[:, None] * w[None, :] * vals))


def spline_integrate(r: np.ndarray, f: np.ndarray, m: int = 0) -> float:
    return Spline(np.asarray(r), f).integrate(m)


_QUAD_WEIGHT_CACHE: dict = {}


def spline_quadrature_weights(r: np.ndarray) -> np.ndarray:
    """Weights w with sum_i w_i v_i == integral of the not-a-knot cubic
    spline through (r_i, v_i). Spline integration is a linear functional of
    the values, so the weights are grid-only and cached per grid."""
    r = np.asarray(r, dtype=np.float64)
    key = (len(r), float(r[0]), float(r[-1]), hash(r.tobytes()))
    w = _QUAD_WEIGHT_CACHE.get(key)
    if w is None:
        # cardinal-basis integrals; CubicSpline supports vectorized values, so
        # spline all n unit vectors in one call
        cs = CubicSpline(r, np.eye(len(r)), axis=0, bc_type="not-a-knot")
        anti = cs.antiderivative()
        w = anti(r[-1]) - anti(r[0])
        _QUAD_WEIGHT_CACHE[key] = w
    return w


def sbessel_integral(
    r: np.ndarray, f: np.ndarray, l: int, q: np.ndarray, m: int = 2
) -> np.ndarray:
    """int f(r) j_l(q r) r^m dr for each q (vectorized over q).

    The workhorse of all G-space constructions (reference
    Radial_integrals_{beta,vloc,rho_*,aug}). Spline-exact quadrature of the
    gridded integrand reduces to one (nq, nr) @ (nr,) matrix product against
    cached grid-only spline weights.
    """
    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    wbase = spline_quadrature_weights(r) * f * r**m
    jl = spherical_jn(l, q[:, None] * r[None, :])
    return jl @ wbase


@dataclasses.dataclass(frozen=True)
class RadialIntegralTable:
    """f(q) tabulated on a uniform q-grid with cubic interpolation, the
    device-friendly form of the reference's splined Radial_integrals tables."""

    qgrid: np.ndarray  # uniform, q[0] = 0
    table: np.ndarray  # (..., nq) values

    @property
    def _interp(self) -> CubicSpline:
        cs = getattr(self, "_interp_cache", None)
        if cs is None:
            flat = self.table.reshape(-1, self.table.shape[-1])
            cs = CubicSpline(self.qgrid, flat, axis=1)
            object.__setattr__(self, "_interp_cache", cs)
        return cs

    @staticmethod
    def build(
        r: np.ndarray,
        functions: np.ndarray,  # (nfun, nr) radial functions
        ls: np.ndarray,  # (nfun,) angular momentum per function
        qmax: float,
        m: int = 2,
        num_q: int | None = None,
    ) -> "RadialIntegralTable":
        if num_q is None:
            # reference grid, EXACTLY (radial_integrals.hpp:54-57):
            # span qmax + max(10, 0.1 qmax) with nprii (= 20 for beta/aug/
            # wf) points per unit q — the ~1e-6-relative spline error of
            # that spacing is part of the reference's numerical definition
            # (test32's 2e-5 eval_sum sensitivity)
            qspan = qmax + max(10.0, 0.1 * qmax)
            num_q = int(20 * qspan)
            qmax = qspan
        qgrid = np.linspace(0.0, qmax, num_q)
        tab = np.stack(
            [sbessel_integral(r, fn, int(l), qgrid, m=m) for fn, l in zip(functions, ls)]
        )
        return RadialIntegralTable(qgrid=qgrid, table=tab)

    def __call__(self, q: np.ndarray) -> np.ndarray:
        """Interpolate every tabulated function at q; returns (..., len(q)).

        Raises on q beyond the tabulated range — silent flat extrapolation
        would poison high-G physics (the reference's Radial_integrals::iqdq
        throws likewise, radial_integrals.hpp:67)."""
        q = np.asarray(q, dtype=np.float64)
        if q.size and float(q.max()) > self.qgrid[-1] * (1 + 1e-12) + 1e-12:
            raise ValueError(
                f"q={float(q.max()):.6g} beyond table qmax={self.qgrid[-1]:.6g}"
            )
        q = np.clip(q, self.qgrid[0], self.qgrid[-1])
        out = self._interp(q)
        return out.reshape(self.table.shape[:-1] + q.shape)
