"""Spherical harmonics (complex Ylm, real Rlm) and Gaunt coefficients.

Replaces the reference's src/core/sht/ (sht.hpp, gaunt.hpp). The reference
uses GSL for Legendre polynomials and precomputed Gaunt tables; here the
associated-Legendre recurrence is implemented directly in numpy, and
Gaunt coefficients are computed by exact Gauss-Legendre x uniform-phi
quadrature (the integrands are trigonometric polynomials of known degree, so
the quadrature is exact to machine precision).

Conventions:
  - lm compound index: lm = l^2 + l + m, m in [-l, l]  (reference utils::lm)
  - Ylm with Condon-Shortley phase (physics convention, matches GSL/SIRIUS)
  - Real harmonics: R_l0 = Y_l0;
      R_lm = sqrt(2) (-1)^m Re Y_l^m      (m > 0)
      R_lm = sqrt(2) (-1)^m Im Y_l^|m|    (m < 0)
"""

from __future__ import annotations

import numpy as np


def lm_index(l, m):
    return l * l + l + m


def num_lm(lmax: int) -> int:
    return (lmax + 1) * (lmax + 1)


def _legendre_bar(lmax: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre P̄_l^m(x) for 0 <= m <= l <= lmax.

    P̄ includes the sqrt((2l+1)/(4pi) (l-m)!/(l+m)!) normalization and the
    Condon-Shortley (-1)^m, so Y_lm = P̄_l^m(cos th) e^{i m phi}.
    Returns array [lmax+1, lmax+1, ...x.shape] indexed [l, m].
    """
    x = np.asarray(x, dtype=np.float64)
    s = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    P = np.zeros((lmax + 1, lmax + 1) + x.shape)
    P[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
    for m in range(1, lmax + 1):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * P[m - 1, m - 1]
    for m in range(0, lmax):
        P[m + 1, m] = np.sqrt(2 * m + 3.0) * x * P[m, m]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


def _theta_phi(rhat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    rhat = np.asarray(rhat, dtype=np.float64)
    ct = np.clip(rhat[..., 2], -1.0, 1.0)
    phi = np.arctan2(rhat[..., 1], rhat[..., 0])
    return ct, phi


def ylm_complex(lmax: int, rhat: np.ndarray) -> np.ndarray:
    """Complex Y_lm at unit vectors rhat [..., 3] -> [..., (lmax+1)^2]."""
    ct, phi = _theta_phi(rhat)
    P = _legendre_bar(lmax, ct)
    out = np.zeros(ct.shape + (num_lm(lmax),), dtype=np.complex128)
    for l in range(lmax + 1):
        out[..., lm_index(l, 0)] = P[l, 0]
        for m in range(1, l + 1):
            e = np.exp(1j * m * phi)
            ylm = P[l, m] * e
            out[..., lm_index(l, m)] = ylm
            out[..., lm_index(l, -m)] = (-1.0) ** m * np.conj(ylm)
    return out


def ylm_real(lmax: int, rhat: np.ndarray) -> np.ndarray:
    """Real R_lm at unit vectors rhat [..., 3] -> [..., (lmax+1)^2]."""
    ct, phi = _theta_phi(rhat)
    P = _legendre_bar(lmax, ct)
    out = np.zeros(ct.shape + (num_lm(lmax),))
    sqrt2 = np.sqrt(2.0)
    for l in range(lmax + 1):
        out[..., lm_index(l, 0)] = P[l, 0]
        for m in range(1, l + 1):
            cs = (-1.0) ** m
            out[..., lm_index(l, m)] = sqrt2 * cs * P[l, m] * np.cos(m * phi)
            out[..., lm_index(l, -m)] = sqrt2 * cs * P[l, m] * np.sin(m * phi)
    return out


def _sphere_quadrature(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature (points[n,3], weights[n]) exact for spherical polynomials
    (products of Ylm) up to the given total degree."""
    nt = degree // 2 + 1
    x, wt = np.polynomial.legendre.leggauss(nt)
    nphi = degree + 1
    phi = 2.0 * np.pi * np.arange(nphi) / nphi
    wphi = 2.0 * np.pi / nphi
    ct, pp = np.meshgrid(x, phi, indexing="ij")
    st = np.sqrt(1.0 - ct**2)
    pts = np.stack([st * np.cos(pp), st * np.sin(pp), ct], axis=-1).reshape(-1, 3)
    w = (wt[:, None] * wphi * np.ones_like(pp)).ravel()
    return pts, w


def gaunt_ylm(lmax1: int, lmax2: int, lmax3: int) -> np.ndarray:
    """Complex Gaunt table G[lm1, lm2, lm3] = int Y*_{l1m1} Y_{l2m2} Y_{l3m3}.

    (reference gaunt.hpp Gaunt_coefficients<complex>)"""
    pts, w = _sphere_quadrature(lmax1 + lmax2 + lmax3)
    y1 = ylm_complex(lmax1, pts)
    y2 = ylm_complex(lmax2, pts)
    y3 = ylm_complex(lmax3, pts)
    return np.einsum("n,na,nb,nc->abc", w, np.conj(y1), y2, y3, optimize=True)


def gaunt_rlm(lmax1: int, lmax2: int, lmax3: int) -> np.ndarray:
    """Real Gaunt table G[lm1, lm2, lm3] = int R_{l1m1} R_{l2m2} R_{l3m3}.

    Used for ultrasoft/PAW augmentation Q_{xi xi'}(G) expansion and MT work
    (reference gaunt.hpp Gaunt_coefficients<double>)."""
    pts, w = _sphere_quadrature(lmax1 + lmax2 + lmax3)
    r1 = ylm_real(lmax1, pts)
    r2 = ylm_real(lmax2, pts)
    r3 = ylm_real(lmax3, pts)
    return np.einsum("n,na,nb,nc->abc", w, r1, r2, r3, optimize=True)
