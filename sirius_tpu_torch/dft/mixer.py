"""Density mixers (reference: src/mixer/ — Linear and Anderson over the
G-space charge density, mixer.hpp:37-63, anderson_mixer.hpp).

Mirrors sirius_tpu/dft/mixer.py::Mixer for the kinds of this slice,
``linear`` and ``anderson`` (``broyden1`` aliases Anderson), on device
tensors: the mixed vector is rho(G) on the fine set, followed by m_z(G) in
a collinear run ([rho; m], complex128). The
Anderson least-squares system is m x m (m <= max_history) and is solved on
the host with numpy, exactly as the JAX package's host path does.

Algorithms (limited-memory quasi-Newton on x_{n+1} = x_n - G_n f_n):
  linear     G_n = -beta I
  anderson   type-II multisecant, normal-equations least squares through a
             truncated eigendecomposition of the Gram matrix
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device


class Mixer:
    KNOWN = ("linear", "anderson", "broyden1")
    LATER = ("anderson_stable", "broyden2")

    def __init__(self, cfg, glen2: np.ndarray, omega: float, device=None,
                 num_components: int = 1):
        """num_components G-sized components, charge first, then the
        magnetization (no trailing passive entries in this slice). Channel
        metric (reference mixer_functions.cpp): the plain inner product
        Omega sum_G f*(G) g(G), or for the charge with use_hartree
        4 pi sum_{G!=0} f* g / G^2; the rms is inner / Omega per channel,
        so a magnetization channel has weight Omega and rms weight 1."""
        if cfg.type in self.LATER:
            raise NotImplementedError(
                f"mixer type '{cfg.type}' comes with ROADMAP queue 1, item "
                "4; the port mixes linear, anderson and broyden1")
        if cfg.type not in self.KNOWN:
            raise ValueError(
                f"unknown mixer type '{cfg.type}' (supported: {self.KNOWN})")
        device = resolve_device(device)
        self.beta = cfg.beta
        self.max_history = cfg.max_history
        self.kind = "anderson" if cfg.type == "broyden1" else cfg.type
        self.use_hartree = bool(cfg.use_hartree)
        ng = len(glen2)
        g2 = np.where(glen2 > 1e-12, glen2, np.inf)
        eha_w = 2.0 * np.pi * omega / g2
        if self.use_hartree:
            w_charge = 4.0 * np.pi / g2
            rms_charge = omega * w_charge
        else:
            w_charge = np.full(ng, omega)
            rms_charge = np.ones(ng)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        extra = num_components - 1
        self.weight = t(np.concatenate([w_charge] + [np.full(ng, omega)] * extra))
        self.rms_weight = t(np.concatenate([rms_charge] + [np.ones(ng)] * extra))
        self._eha_w = t(eha_w)
        self._x: list[torch.Tensor] = []  # input history
        self._f: list[torch.Tensor] = []  # residual history f = x_out - x_in

    def residual_hartree_energy(self, x_mixed, x_new) -> float:
        """Hartree energy of the charge residual (mixed - new):
        2 pi Omega sum_{G!=0} |drho_G|^2 / G^2 (reference poisson.cpp
        density_residual_hartree_energy)."""
        n = self._eha_w.shape[0]
        d = x_mixed[:n] - x_new[:n]
        return float(torch.sum(self._eha_w * (d.conj() * d).real))

    def rms(self, x_in, x_out) -> float:
        """sqrt of inner(d, d)/size (reference mixer.hpp update_rms with
        normalize=true)."""
        d = x_out - x_in
        return float(torch.sqrt(torch.clamp(
            torch.sum(self.rms_weight * (d.conj() * d).real), min=0.0)))

    def _mix_anderson(self, x_in, f):
        # type-II Anderson: minimize ||f - sum g_j df_j|| in the metric.
        # Solved through a truncated eigendecomposition of the Gram matrix:
        # near machine-precision residuals the df_j become numerically
        # collinear and the raw normal equations extrapolate wildly (the
        # reference guards the same way, anderson_mixer.hpp:137-140).
        dfs = torch.stack([f - fj for fj in self._f])  # [m, n]
        dxs = torch.stack([x_in - xj for xj in self._x])
        wd = dfs.conj() * self.weight
        a = (wd @ dfs.mT).real.cpu().numpy()
        b = (wd @ f).real.cpu().numpy()
        g = np.zeros(len(self._x))
        if np.all(np.isfinite(a)) and np.all(np.isfinite(b)):
            try:
                w, v = np.linalg.eigh(0.5 * (a + a.conj().T))
            except np.linalg.LinAlgError:
                w = v = None
            if w is not None:
                keep = w > 1e-12 * max(float(w[-1]), 0.0)
                if np.any(keep):
                    g = np.real(
                        v[:, keep] @ ((v[:, keep].conj().T @ b) / w[keep]))
        gt = torch.as_tensor(g, dtype=x_in.dtype, device=x_in.device)
        x_opt = x_in - gt @ dxs
        f_opt = f - gt @ dfs
        out = x_opt + self.beta * f_opt
        if not bool(torch.all(torch.isfinite(torch.view_as_real(out)))):
            return x_in + self.beta * f  # plain damped step
        return out

    def mix(self, x_in, x_out):
        f = x_out - x_in
        if self.kind == "linear" or not self._x:
            nxt = x_in + self.beta * f
        else:
            nxt = self._mix_anderson(x_in, f)
        self._x.append(x_in.clone())
        self._f.append(f.clone())
        if len(self._x) > self.max_history:
            self._x.pop(0)
            self._f.pop(0)
        return nxt


def schedule_res_tol(itsol, res_tol: float, dens_metric: float, nel: float,
                     hartree_metric: bool) -> float:
    """Next iteration's band-solve residual bar from the density residual
    (reference dft_ground_state.cpp:252-259): tol = min(scale0 * metric,
    scale1 * tol_prev), clamped at min_tolerance. With the Hartree metric
    the density bar is an energy — scale it per electron as the reference
    does before feeding the solver."""
    m = dens_metric / max(1.0, nel) if hartree_metric else dens_metric
    return max(
        itsol.min_tolerance,
        min(itsol.tolerance_scale[0] * m,
            itsol.tolerance_scale[1] * res_tol),
    )
