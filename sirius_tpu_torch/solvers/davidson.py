"""Blocked iterative eigensolver for (H, S), batched over (k, spin).

Mirrors sirius_tpu/solvers/davidson.py: a locked-block LOBPCG-style
iteration with a constant 3*nb subspace [X, K R, P], H X / H P carried
through the steps and refreshed with a true application every
REFRESH_EVERY steps, a fixed step count with no early exit, and the same
rank-revealing (eigh-based) Rayleigh-Ritz. The JAX package vmaps one
(k, spin) solve; here every block carries a leading batch axis B and the
subspace algebra is batched matmul / torch.linalg.eigh. The residual,
convergence mask and preconditioner are K2 (kernels/davidson_residual.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.kernels.davidson_residual import davidson_residual

# refresh cadence of the carried H X / H P blocks; scf.py's H-application
# counter derives from this, keep them in sync via this constant
REFRESH_EVERY = 5


def num_applies(num_steps: int, nb: int, refresh_every: int = REFRESH_EVERY) -> int:
    """H-applications (in band rows) of one davidson() call: nb at the first
    boundary (P still zero), 2nb at later chunk boundaries, nb per step for
    the new block, nb on exit."""
    nchunks = -(-num_steps // refresh_every)
    return nb * (num_steps + 2 * nchunks)


def residual_health(rnorm, blowup: float = 1e2) -> tuple[float, bool]:
    """(max residual norm, healthy?) of a band solve's exit residuals. A
    non-finite or blown-up residual means the solver stagnated or the
    subspace collapsed; run_scf then retries with a deeper subspace."""
    r = np.asarray(torch.as_tensor(rnorm).detach().cpu(), dtype=np.float64)
    if r.size == 0:
        return 0.0, True
    rmax = float(np.max(r)) if np.all(np.isfinite(r)) else float("inf")
    return rmax, bool(np.isfinite(rmax) and rmax <= blowup)


def _herm(a):
    return 0.5 * (a + a.mH)


# PyTorch's CUDA eigh hands a float32 matrix of order 32 to SYEVJ_MAX to
# cuSOLVER's Jacobi syevj, and every other one to syevd, the divide and
# conquer LAPACK runs on the CPU. Padded past SYEVJ_MAX, a float32 matrix
# of order PAD_FROM or more reaches syevd sooner than Jacobi solves it
# (H100: Jacobi 4.9 ms against 5.4 padded at 256, 6.0 against 5.5 at 288,
# 10.7 against 5.6 at 387, the 54-atom Gamma subspace; PERF.md §5)
SYEVJ_MAX = 512
PAD_FROM = 288


def takes_syevj(a) -> bool:
    """Whether torch.linalg.eigh would run a through cuSOLVER's Jacobi."""
    return (a.device.type == "cuda" and a.dtype == torch.float32
            and 32 <= a.shape[-1] <= SYEVJ_MAX)


def eigh_padded(a, m: int):
    """torch.linalg.eigh of a batched Hermitian [..., n, n] through a
    matrix of order m > n: a, then a diagonal block above a's Gershgorin
    bound, so its n lowest eigenpairs are a's (its eigenvectors' trailing
    rows are zero)."""
    n = a.shape[-1]
    top = 1.0 + a.abs().sum(-1).amax(-1)
    big = torch.zeros(a.shape[:-2] + (m, m), dtype=a.dtype, device=a.device)
    big[..., :n, :n] = a
    big[..., n:, n:] = torch.diag_embed(
        top[..., None].expand(a.shape[:-2] + (m - n,)))
    e, v = torch.linalg.eigh(big)
    return e[..., :n], v[..., :n, :n]


def _eigh(a):
    """torch.linalg.eigh in its working type; a matrix of order PAD_FROM
    or more that the card would solve by Jacobi is padded past SYEVJ_MAX
    to reach syevd, as the CPU's LAPACK solves it."""
    if takes_syevj(a) and a.shape[-1] >= PAD_FROM:
        return eigh_padded(a, SYEVJ_MAX + 1)
    return torch.linalg.eigh(a)


def _rayleigh_ritz(hsub, ssub, nev: int):
    """Lowest-nev gen-EVP of a possibly rank-deficient batched subspace pair
    [B, m, m]. Returns (e [B, nev], c [B, m, nev]).

    The dropped (near-dependent) directions are zero rows and columns of
    the reduced matrix; each gets a diagonal shift above the Gershgorin
    bound of the kept block, so the kept block's eigenpairs come first, as
    with the JAX package's fixed 1e6. The bound keeps the matrix's norm at
    the scale of H: cuSOLVER's eigh on the card is accurate relative to that
    norm, and a 1e6 entry cost the ultrasoft parity deck ~1e-8 Ha.

    The reduced matrix t^H H t is averaged with its conjugate transpose
    before eigh, as jnp.linalg.eigh symmetrizes its input: its triangles
    differ by rounding, amplified by t's large entries along near-dependent
    directions, and torch's eigh reads one of them. Reading one let the
    carried H X / H P blocks drift: the first fp32 band solve of the small
    US deck ended 1.3e-5 Ha off (2e-7 with the average), and the fp64 SCF
    of the 2-atom US + 48-op deck stalled at residuals of 1e-11 to 1e-8."""
    s, u = _eigh(ssub)
    smax = torch.amax(s.abs(), dim=-1, keepdim=True)
    # the working precision's eps: the subspace carries its rounding
    # (sirius_tpu/solvers/davidson.py:67-75)
    eps = torch.finfo(ssub.dtype).eps
    good = s > max(50.0 * eps, 1e-11) * smax
    scale = torch.where(good, torch.rsqrt(torch.where(good, s, 1.0)), 0.0)
    t = u * scale[..., None, :].to(u.dtype)
    at = t.mH @ hsub @ t
    at = _herm(at)
    shift = 1.0 + torch.amax(at.abs().sum(dim=-1), dim=-1, keepdim=True)
    at = at + torch.diag_embed(torch.where(good, 0.0, shift).to(at.dtype))
    e, y = _eigh(at)
    c = t @ y
    return e[..., :nev], c[..., :nev]


def subspace_rotate(x, hx, sx, nb: int, mask=None):
    """Lowest-nb Ritz vectors of the trial block x [B, m, ngk] given H x and
    S x (LCAO subspace initialization)."""
    hsub = _herm(x.conj() @ hx.mT)
    ssub = _herm(x.conj() @ sx.mT)
    _, c = _rayleigh_ritz(hsub, ssub, nb)
    ct = c.mT
    xn = ct @ x
    if mask is not None:
        xn = xn * mask[:, None, :]
    nrm = torch.sum(xn.conj() * (ct @ sx), dim=-1).real
    return xn / torch.sqrt(torch.clamp(nrm, min=1e-30))[..., None]


def davidson(apply_fn, params, x0, h_diag, o_diag, mask,
             num_steps: int = 20, res_tol: float = 1e-6,
             refresh_every: int = REFRESH_EVERY):
    """Batched solve. apply_fn(params, psi [B, R, ngk]) -> (H psi, S psi);
    x0 [B, nb, ngk]; h_diag, o_diag, mask [B, ngk].
    Returns (evals [B, nb], X [B, nb, ngk], res_norms [B, nb])."""
    nb = x0.shape[1]
    m = mask[:, None, :]

    def ortho(x):
        xm = x * m
        g = xm @ xm.mH
        s, u = _eigh(g)
        good = s > 50.0 * torch.finfo(g.dtype).eps * torch.amax(
            s.abs(), dim=-1, keepdim=True)
        scale = torch.where(good, torch.rsqrt(torch.where(good, s, 1.0)), 0.0)
        t = u * scale[..., None, :].to(u.dtype)
        return t.mH @ x

    x = ortho(x0 * m)

    def step(x, hx, sx, p, hp, sp):
        _, _, w = davidson_residual(x, hx, sx, h_diag, o_diag, mask, res_tol)
        # project out X and normalize rows: keeps the 3nb overlap matrix
        # well-conditioned so the rank-revealing cutoff doesn't stall
        w = w - (w @ x.mH) @ x
        w = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                            min=1e-30)
        hw, sw = apply_fn(params, w)
        v = torch.cat([x, w, p], dim=1)  # [B, 3nb, ngk]
        hv = torch.cat([hx, hw, hp], dim=1)
        sv = torch.cat([sx, sw, sp], dim=1)
        hsub = _herm(v.conj() @ hv.mT)
        ssub = _herm(v.conj() @ sv.mT)
        _, c = _rayleigh_ritz(hsub, ssub, nb)
        ct = c.mT
        xn = (ct @ v) * m
        hxn = (ct @ hv) * m
        sxn = (ct @ sv) * m
        cpt = ct.clone()
        cpt[..., :nb] = 0.0  # the non-X part of the update
        pn = (cpt @ v) * m
        pscale = 1.0 / torch.clamp(torch.linalg.norm(pn, dim=-1, keepdim=True),
                                   min=1e-30)
        return (xn, hxn, sxn, pn * pscale, (cpt @ hv) * m * pscale,
                (cpt @ sv) * m * pscale)

    p = hp = sp = torch.zeros_like(x)
    done = 0
    while done < num_steps:
        steps = min(refresh_every, num_steps - done)
        if done == 0:
            # P is exactly zero before the first chunk: only X needs applying
            hx, sx = apply_fn(params, x)
        else:
            # chunk-boundary refresh: true H/S application to [X; P]
            hxp, sxp = apply_fn(params, torch.cat([x, p], dim=1))
            hx, sx = hxp[:, :nb], sxp[:, :nb]
            hp, sp = hxp[:, nb:], sxp[:, nb:]
        for _ in range(steps):
            x, hx, sx, p, hp, sp = step(x, hx, sx, p, hp, sp)
        done += steps
    # fresh application for the exit values
    hx, sx = apply_fn(params, x)
    evals, rnorm, _ = davidson_residual(x, hx, sx, None, None, None, res_tol,
                                        want_w=False)
    den = torch.sum(x.conj() * sx, dim=-1).real
    x = x / torch.sqrt(torch.clamp(den, min=1e-30))[..., None]
    return evals, x, rnorm
