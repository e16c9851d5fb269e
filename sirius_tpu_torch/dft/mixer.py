"""Density mixers (reference: src/mixer/ — Linear, Anderson, Anderson_stable
and Broyden2 over the G-space charge density, mixer.hpp:37-63,
mixer_factory.hpp:40-47, where "broyden1" is a backward-compatibility alias
of Anderson).

Mirrors sirius_tpu/dft/mixer.py::Mixer on device tensors: the mixed vector
is rho(G) on the fine set, followed by the magnetization components
([rho; m], complex128) and any passive trailing entries (extra_len). The
small systems of the quasi-Newton schemes (m x m, m <= max_history) are
solved on the host with numpy, exactly as the JAX package's host path
does; the history and the vectors stay on the device.

Algorithms (limited-memory quasi-Newton on x_{n+1} = x_n - G_n f_n):
  linear           G_n = -beta I
  anderson         type-II multisecant, normal-equations least squares
                   through a truncated eigendecomposition of the Gram matrix
  anderson_stable  the same least-squares problem through a metric-weighted
                   QR of the residual-difference block (reference
                   anderson_stable_mixer.hpp, Fang & Saad 2009)
  broyden2         recursive rank-1 inverse-Jacobian updates; the alpha_i
                   recursion of broyden2_mixer.hpp:63-80
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device


class Mixer:
    KNOWN = ("linear", "anderson", "anderson_stable", "broyden1", "broyden2")

    def __init__(self, cfg, glen2: np.ndarray, omega: float, device=None,
                 num_components: int = 1, extra_len: int = 0):
        """num_components G-sized components, charge first, then the
        magnetization; extra_len trailing flat entries (occupation and PAW
        density matrices) mixed passively: the reference gives them a zero
        inner product (mixer_functions.cpp, "do not contribute to mixing"),
        so they never steer the coefficients or the rms. Channel metric
        (reference mixer_functions.cpp): the plain inner product
        Omega sum_G f*(G) g(G), or for the charge with use_hartree
        4 pi sum_{G!=0} f* g / G^2; the rms is inner / Omega per channel,
        so a magnetization channel has weight Omega and rms weight 1."""
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
        passive = [np.zeros(extra_len)]
        self.weight = t(np.concatenate([w_charge] + [np.full(ng, omega)] * extra
                                       + passive))
        self.rms_weight = t(np.concatenate([rms_charge] + [np.ones(ng)] * extra
                                           + passive))
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

    def _diff_blocks(self, x_in, f):
        """Successive-difference blocks [n, m], DF[:, i] = f_{i+1} - f_i and
        DX alike, with the current point as the newest history entry."""
        xs = self._x + [x_in]
        fs = self._f + [f]
        dfs = torch.stack([fs[i + 1] - fs[i] for i in range(len(fs) - 1)],
                          dim=1)
        dxs = torch.stack([xs[i + 1] - xs[i] for i in range(len(xs) - 1)],
                          dim=1)
        return dfs, dxs

    def _mix_anderson_stable(self, x_in, f):
        # the same least-squares problem through a metric-weighted QR of DF
        # (reference anderson_stable_mixer.hpp):
        #   x+ = x + beta (f - DF k) - DX k,   k = R^{-1} Q^H W^{1/2} f
        # The projection DF k is formed in unweighted space: components with
        # zero metric weight (the G = 0 charge row under the Hartree metric,
        # the passive entries) must not be divided back by W^{-1/2}.
        dfs, dxs = self._diff_blocks(x_in, f)
        sw = torch.sqrt(self.weight).to(dfs.dtype)
        q, r = torch.linalg.qr(sw[:, None] * dfs, mode="reduced")
        # guard rank deficiency: drop near-dependent directions, then
        # re-factorize the kept columns (subsetting Q and R of the original
        # QR would not factor the kept block unless only trailing columns
        # drop)
        diag = np.abs(np.diag(r.cpu().numpy()))
        keep = diag > 1e-12 * max(diag.max(), 1e-300)
        if not np.all(keep):
            cols = torch.as_tensor(np.nonzero(keep)[0], device=dfs.device)
            dfs, dxs = dfs[:, cols], dxs[:, cols]
            if dfs.shape[1] == 0:
                return x_in + self.beta * f
            q, r = torch.linalg.qr(sw[:, None] * dfs, mode="reduced")
        h = (q.mH @ (sw * f)).cpu().numpy()
        try:
            k = np.linalg.solve(r.cpu().numpy(), h)
        except np.linalg.LinAlgError:
            return x_in + self.beta * f
        kt = torch.as_tensor(k, device=dfs.device)
        return x_in + self.beta * (f - dfs @ kt) - dxs @ kt

    def _mix_broyden2(self, x_in, f):
        # recursive rank-1 inverse-Jacobian update, G_1 = -beta I (reference
        # broyden2_mixer.hpp:63-80):
        #   alpha_i = [<df_i, f_n> - sum_{j>i} alpha_j <df_i, df_j>]
        #             / <df_i, df_i>
        #   x+ = x + beta f - sum_i alpha_i (beta df_i + dx_i)
        dfs, dxs = self._diff_blocks(x_in, f)
        m = dfs.shape[1]
        wd = dfs.mT.conj() * self.weight
        gram = (wd @ dfs).real.cpu().numpy()
        rhs = (wd @ f).real.cpu().numpy()
        alpha = np.zeros(m)
        for i in range(m - 1, -1, -1):
            num = rhs[i] - sum(alpha[j] * gram[i, j] for j in range(i + 1, m))
            alpha[i] = num / gram[i, i] if gram[i, i] > 1e-300 else 0.0
        at = torch.as_tensor(alpha, dtype=dfs.dtype, device=dfs.device)
        return x_in + self.beta * f - dfs @ (self.beta * at) - dxs @ at

    def mix(self, x_in, x_out):
        f = x_out - x_in
        if self.kind == "linear" or not self._x:
            nxt = x_in + self.beta * f
        elif self.kind == "anderson":
            nxt = self._mix_anderson(x_in, f)
        elif self.kind == "anderson_stable":
            nxt = self._mix_anderson_stable(x_in, f)
        else:
            nxt = self._mix_broyden2(x_in, f)
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
