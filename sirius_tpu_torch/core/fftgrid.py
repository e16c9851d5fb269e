"""FFT grid: box dimensioning and batched G<->r transforms.

Replaces the reference's fft::Grid / SpFFT wrappers (src/core/fft/fft3d_grid.hpp,
fft.hpp:29-95). The transforms are whole-box batched torch.fft calls (cuFFT
on the card) around K1's scatter and gather kernels (kernels/local_hpsi.py).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from sirius_tpu_torch.kernels.local_hpsi import box_to_pw_hpsi, pw_to_box

# FFT-friendly sizes: products of 2,3,5,7.
_SMOOTH_PRIMES = (2, 3, 5, 7)


def _is_smooth(n: int) -> bool:
    for p in _SMOOTH_PRIMES:
        while n % p == 0:
            n //= p
    return n == 1


def good_fft_size(n: int) -> int:
    """Smallest 7-smooth integer >= n (reference: fft3d_grid.hpp find_grid_size)."""
    n = max(1, int(n))
    while not _is_smooth(n):
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class FFTGrid:
    """A real-space/reciprocal-space FFT box.

    dims: (n1, n2, n3) grid divisions along the three lattice vectors.
    The flattened ("linear") index convention is row-major over (i1, i2, i3),
    matching a row-major reshape of an array of shape dims.
    """

    dims: tuple[int, int, int]

    @staticmethod
    def for_cutoff(lattice: np.ndarray, gmax: float) -> "FFTGrid":
        """Minimal box holding the |G| <= gmax sphere.

        lattice: rows are lattice vectors a_i (bohr). The box needs
        n_i >= 2*m_i + 1 where m_i is the max Miller index along b_i inside
        the sphere: m_i = floor(gmax * |a_i| / (2 pi)).
        """
        a = np.asarray(lattice, dtype=np.float64)
        lens = np.linalg.norm(a, axis=1)
        m = np.floor(gmax * lens / (2 * np.pi)).astype(int)
        dims = tuple(good_fft_size(int(2 * mi + 2)) for mi in m)
        return FFTGrid(dims)

    @staticmethod
    def ref_min_grid(lattice: np.ndarray, gmax: float) -> "FFTGrid":
        """The reference's box sizing, exactly (fft3d_grid.hpp get_min_grid
        + r3::find_translations + find_grid_size 5-smooth rounding). The
        nonlinear XC is evaluated on this real-space box, so its SIZE is
        part of the reference's numerical definition — energy parity at
        the 1e-5 level requires the same dims, not merely sufficient ones.
        """
        a = np.asarray(lattice, dtype=np.float64)
        # reference: find_translations(cutoff, RECIPROCAL lattice) — the
        # count of b-lattice translations inside the diameter
        b = 2.0 * np.pi * np.linalg.inv(a)  # columns of b are b_i? rows:
        b = b.T  # rows are b_i
        det = abs(np.linalg.det(b))
        cr = [
            np.cross(b[1], b[2]),
            np.cross(b[0], b[2]),
            np.cross(b[0], b[1]),
        ]
        lim = [int(2.0 * gmax * np.linalg.norm(c) / det) + 1 for c in cr]

        def smooth5(n: int) -> int:
            while True:
                m = n
                for k in (2, 3, 5):
                    while m % k == 0:
                        m //= k
                if m == 1:
                    return n
                n += 1

        return FFTGrid(tuple(smooth5(l + 2) for l in lim))

    @property
    def num_points(self) -> int:
        n1, n2, n3 = self.dims
        return n1 * n2 * n3

    def grid_coords(self) -> np.ndarray:
        """Fractional coordinates of all grid points, shape (N, 3)."""
        n1, n2, n3 = self.dims
        i1, i2, i3 = np.meshgrid(
            np.arange(n1), np.arange(n2), np.arange(n3), indexing="ij"
        )
        frac = np.stack(
            [i1.ravel() / n1, i2.ravel() / n2, i3.ravel() / n3], axis=1
        )
        return frac

    def miller_to_linear(self, millers: np.ndarray) -> np.ndarray:
        """Map integer Miller indices (h,k,l) -> flattened FFT box index.

        Negative frequencies wrap (h mod n1), matching the standard DFT
        frequency layout used by torch.fft.fftn.
        """
        n1, n2, n3 = self.dims
        h = np.mod(millers[:, 0], n1)
        k = np.mod(millers[:, 1], n2)
        l = np.mod(millers[:, 2], n3)
        return ((h * n2 + k) * n3 + l).astype(np.int32)


def g_to_r(coeffs: torch.Tensor, fft_index: torch.Tensor,
           dims: tuple[int, int, int]) -> torch.Tensor:
    """Batched G -> r transform: scatter PW coefficients into the box and
    inverse-FFT. coeffs: [..., ng] complex128; fft_index: [ng] int32;
    returns [..., n1, n2, n3].

    Convention: f(r) = sum_G f(G) e^{iGr}, the unnormalized inverse FFT
    (N * ifftn of the box).
    """
    batch = coeffs.shape[:-1]
    ng = coeffs.shape[-1]
    n = dims[0] * dims[1] * dims[2]
    box = pw_to_box(coeffs.reshape(1, -1, ng), fft_index, None, n)
    box = box.reshape(batch + tuple(dims))
    return torch.fft.ifftn(box, dim=(-3, -2, -1), norm="forward")


def r_to_g(values: torch.Tensor, fft_index: torch.Tensor,
           dims: tuple[int, int, int]) -> torch.Tensor:
    """Batched r -> G transform: FFT the box and gather sphere coefficients.

    values: [..., n1, n2, n3]; returns [..., ng] complex128.
    Convention: f(G) = (1/N) sum_r f(r) e^{-iGr} == fftn(values)/N.
    """
    return box_to_g(values.to(torch.complex128), fft_index, dims)


def box_to_g(box: torch.Tensor, fft_index: torch.Tensor,
             dims: tuple[int, int, int]) -> torch.Tensor:
    """r_to_g of a complex128 box [..., n1, n2, n3] (a real field already
    in complex form, e.g. K17b's V_xc): the forward FFT, then K1's sphere
    gather; returns [..., ng]."""
    n = dims[0] * dims[1] * dims[2]
    batch = box.shape[:-3]
    box = torch.fft.fftn(box, dim=(-3, -2, -1), norm="forward")
    out, _ = box_to_pw_hpsi(box.reshape(1, -1, n), None, None, None, fft_index)
    return out.reshape(batch + (fft_index.shape[-1],))
