"""G-vector engine: plane-wave sphere enumeration, shells, index maps.

Replaces the reference's fft::Gvec machinery (src/core/fft/gvec.hpp:124-1000).
The reference distributes G-vectors by z-columns for slab FFTs over MPI;
here G-vectors live in a flat, |G|-sorted array with a Miller->FFT-box index
map on one device.

All enumeration happens host-side in numpy at setup; the arrays the device
code reads (|G|^2, FFT scatter indices) are uploaded once as tensors.

Conventions (matching the reference):
  - lattice: rows are lattice vectors a_i in bohr;
  - reciprocal: B = 2*pi*inv(A)^T, rows b_i;  G = h b1 + k b2 + l b3;
  - cutoffs are on |G| in bohr^-1 (pw_cutoff for the density/potential sphere,
    gk_cutoff for |G+k| wave-function spheres);
  - G-vectors sorted by (|G|^2, h, k, l); index 0 is G=0 for the density set.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sirius_tpu_torch.core.fftgrid import FFTGrid

_SHELL_TOL = 1e-8


def reciprocal_lattice(lattice: np.ndarray) -> np.ndarray:
    """B with rows b_i such that a_i . b_j = 2 pi delta_ij."""
    a = np.asarray(lattice, dtype=np.float64)
    return 2.0 * np.pi * np.linalg.inv(a).T


def _enumerate_sphere(
    recip: np.ndarray, center: np.ndarray, gmax: float, fft: FFTGrid
) -> np.ndarray:
    """Miller indices h with |(h + center) . B| <= gmax, sorted by length then
    lexicographically. center is a fractional k-point (zero for the G set)."""
    # Sphere Miller bound along axis i: |h_i + c_i| <= gmax |a_i| / (2 pi),
    # so the box half-dims must cover t_i + |c_i|.
    a = 2.0 * np.pi * np.linalg.inv(recip).T  # rows a_i (recip = 2pi inv(A)^T)
    t = gmax * np.linalg.norm(a, axis=1) / (2.0 * np.pi)
    # enumeration covers h_i in [-(n_i//2), (n_i-1)//2]; the sphere needs
    # h_i in [ceil(-t_i - c_i), floor(t_i - c_i)] (asymmetric for even dims)
    dims = np.asarray(fft.dims)
    hi_need = np.floor(t - center + 1e-9).astype(int)
    lo_need = np.ceil(-t - center - 1e-9).astype(int)
    if np.any(hi_need > (dims - 1) // 2) or np.any(lo_need < -(dims // 2)):
        raise ValueError(
            f"FFT box {fft.dims} too small for |G+k| <= {gmax} sphere at "
            f"k={center}: need Miller range [{lo_need}, {hi_need}], have "
            f"[{-(dims // 2)}, {(dims - 1) // 2}]"
        )
    n1, n2, n3 = fft.dims
    h = np.arange(-(n1 // 2), (n1 - 1) // 2 + 1)
    k = np.arange(-(n2 // 2), (n2 - 1) // 2 + 1)
    l = np.arange(-(n3 // 2), (n3 - 1) // 2 + 1)
    hh, kk, ll = np.meshgrid(h, k, l, indexing="ij")
    millers = np.stack([hh.ravel(), kk.ravel(), ll.ravel()], axis=1)
    gc = (millers + center[None, :]) @ recip
    g2 = np.sum(gc * gc, axis=1)
    sel = g2 <= gmax * gmax + _SHELL_TOL
    millers = millers[sel]
    g2 = g2[sel]
    order = np.lexsort((millers[:, 2], millers[:, 1], millers[:, 0], np.round(g2, 10)))
    return millers[order]


def _shells(glen2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Group |G|^2 values into shells within tolerance. Returns
    (shell_index per G, shell |G|^2 values)."""
    shell_idx = np.zeros(len(glen2), dtype=np.int32)
    shell_g2 = []
    cur = -1.0
    ns = -1
    for i, g2 in enumerate(glen2):
        if ns < 0 or g2 - cur > _SHELL_TOL * max(1.0, g2):
            ns += 1
            cur = g2
            shell_g2.append(g2)
        shell_idx[i] = ns
    return shell_idx, np.asarray(shell_g2)


@dataclasses.dataclass(frozen=True)
class Gvec:
    """The |G| <= gmax plane-wave set of a lattice (density/potential basis).

    Host-side numpy arrays; the Hamiltonian uploads what it needs as tensors.
    """

    lattice: np.ndarray  # (3,3) rows a_i [bohr]
    recip: np.ndarray  # (3,3) rows b_i [bohr^-1]
    omega: float  # unit cell volume [bohr^3]
    gmax: float
    fft: FFTGrid
    millers: np.ndarray  # (ng, 3) int64
    gcart: np.ndarray  # (ng, 3) f64
    glen2: np.ndarray  # (ng,)
    shell_idx: np.ndarray  # (ng,) int32
    shell_g2: np.ndarray  # (nshell,)
    fft_index: np.ndarray  # (ng,) int32 scatter index into flattened box

    @staticmethod
    def build(lattice: np.ndarray, gmax: float, fft: FFTGrid | None = None) -> "Gvec":
        if gmax <= 0:
            raise ValueError(f"gmax must be positive, got {gmax}")
        a = np.asarray(lattice, dtype=np.float64)
        recip = reciprocal_lattice(a)
        if fft is None:
            fft = FFTGrid.for_cutoff(a, 2.0 * gmax)  # box holds G1-G2 products
        millers = _enumerate_sphere(recip, np.zeros(3), gmax, fft)
        gcart = millers @ recip
        glen2 = np.sum(gcart * gcart, axis=1)
        shell_idx, shell_g2 = _shells(glen2)
        return Gvec(
            lattice=a,
            recip=recip,
            omega=float(abs(np.linalg.det(a))),
            gmax=float(gmax),
            fft=fft,
            millers=millers,
            gcart=gcart,
            glen2=glen2,
            shell_idx=shell_idx,
            shell_g2=shell_g2,
            fft_index=fft.miller_to_linear(millers),
        )

    @property
    def num_gvec(self) -> int:
        return len(self.millers)

    @property
    def num_shells(self) -> int:
        return len(self.shell_g2)

    def index_of_millers(self, millers: np.ndarray) -> np.ndarray:
        """Index of each (h,k,l) row in this set, -1 if absent.

        Used to map coefficient arrays between G-sets (coarse <-> fine grid,
        reference: Simulation_context gvec mappings)."""
        lut = {tuple(m): i for i, m in enumerate(self.millers)}
        return np.asarray(
            [lut.get(tuple(m), -1) for m in np.asarray(millers)], dtype=np.int64
        )


@dataclasses.dataclass(frozen=True)
class GkVec:
    """Batched |G+k| <= gk_cutoff spheres for a set of k-points.

    The reference gives each K_point its own ragged Gvec (k_point.hpp:52-61);
    here we pad every sphere to the common max size so that all per-k arrays
    have static shape [nk, ngk_max] and the whole k-set is one batch
    dimension. Padded slots carry mask=0 and fft_index 0, the slot of G=0:
    the box scatter (kernels/local_hpsi.py) skips them.
    """

    kpoints: np.ndarray  # (nk, 3) fractional
    weights: np.ndarray  # (nk,) IBZ weights, sum = 1
    gk_cutoff: float
    fft: FFTGrid  # coarse box (wave-function grid)
    num_gk: np.ndarray  # (nk,) true sphere sizes
    millers: np.ndarray  # (nk, ngk_max, 3)
    gkcart: np.ndarray  # (nk, ngk_max, 3) cartesian G+k
    mask: np.ndarray  # (nk, ngk_max) 1.0 valid / 0.0 padding
    fft_index: np.ndarray  # (nk, ngk_max) int32

    @staticmethod
    def build(
        gvec: Gvec,
        kpoints: np.ndarray,
        gk_cutoff: float,
        fft: FFTGrid,
        weights: np.ndarray | None = None,
    ) -> "GkVec":
        kpts = np.atleast_2d(np.asarray(kpoints, dtype=np.float64))
        nk = len(kpts)
        if weights is None:
            weights = np.full(nk, 1.0 / nk)
        per_k = [
            _enumerate_sphere(gvec.recip, kpts[ik], gk_cutoff, fft)
            for ik in range(nk)
        ]
        num_gk = np.asarray([len(m) for m in per_k], dtype=np.int32)
        ngk_max = int(num_gk.max())
        millers = np.zeros((nk, ngk_max, 3), dtype=np.int64)
        mask = np.zeros((nk, ngk_max))
        fft_index = np.zeros((nk, ngk_max), dtype=np.int32)
        gkcart = np.zeros((nk, ngk_max, 3))
        for ik, m in enumerate(per_k):
            n = len(m)
            millers[ik, :n] = m
            mask[ik, :n] = 1.0
            fft_index[ik, :n] = fft.miller_to_linear(m)
            gkcart[ik, :n] = (m + kpts[ik][None, :]) @ gvec.recip
        return GkVec(
            kpoints=kpts,
            weights=np.asarray(weights, dtype=np.float64),
            gk_cutoff=float(gk_cutoff),
            fft=fft,
            num_gk=num_gk,
            millers=millers,
            gkcart=gkcart,
            mask=mask,
            fft_index=fft_index,
        )

    @property
    def num_kpoints(self) -> int:
        return len(self.kpoints)

    @property
    def ngk_max(self) -> int:
        return self.millers.shape[1]

    def pad_to(self, ngk: int) -> "GkVec":
        """Widen every sphere to ``ngk`` columns (mask=0 padding).

        Padding columns behave exactly like the existing ragged-sphere
        padding (zero millers/gkcart, fft_index 0, kinetic() -> 1e4), so
        the result is valid for every solver path. Used by the serving
        engine to round ngk_max up to a shape quantum so near-identical
        decks share compiled executables.
        """
        cur = self.ngk_max
        if ngk <= cur:
            return self
        nk = self.num_kpoints
        extra = ngk - cur
        pad3 = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((nk, extra, 3), dtype=a.dtype)], axis=1)
        pad2 = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((nk, extra), dtype=a.dtype)], axis=1)
        return dataclasses.replace(
            self,
            millers=pad3(self.millers),
            gkcart=pad3(self.gkcart),
            mask=pad2(self.mask),
            fft_index=pad2(self.fft_index),
        )

    def kinetic(self) -> np.ndarray:
        """|G+k|^2 / 2 per (k, g); padded slots get a large value so they stay
        out of the low eigenspace in padded diagonalizations."""
        ekin = 0.5 * np.sum(self.gkcart * self.gkcart, axis=-1)
        return np.where(self.mask > 0, ekin, 1e4)
