"""K13: the Fermi level by bisection, the occupations and the entropy sum
(csrc/fermi.cu), with the smearing functions and the plain version.

find_fermi(evals [nk, ns, nb] float64, kweights [nk] float64, nel, width,
kind, max_occupancy, num_iter) returns (mu, occ [nk, ns, nb], entropy_sum),
mu and entropy_sum 0-d tensors on the device of evals. Replaces
sirius_tpu/dft/occupation.py::find_fermi (:68-103). A CPU tensor takes the
plain PyTorch version (find_fermi_plain: the bisection as a Python loop of
torch reductions, about ten launches a step); a CUDA tensor launches the
kernel, one block for the whole search, and reads nothing back.

Smearing definitions: reference src/dft/smearing.cpp (argument
x = E_F - e), as sirius_tpu/dft/occupation.py writes them.
"""

from __future__ import annotations

import math

import torch

from sirius_tpu_torch.kernels import build

SQRT2 = 1.4142135623730951
SQRT_PI = 1.7724538509055159
# the kind numbers of csrc/fermi.cu
KINDS = {"gaussian": 0, "fermi_dirac": 1, "cold": 2, "methfessel_paxton": 3}


def occupancy(kind: str, x: torch.Tensor, w: float) -> torch.Tensor:
    """f(x) in [0, 1] with x = mu - eps (reference smearing.cpp)."""
    t = x / w
    if kind == "gaussian":
        return 0.5 * (1.0 + torch.special.erf(t))
    if kind == "fermi_dirac":
        return 1.0 - 1.0 / (1.0 + torch.exp(torch.clamp(t, -200, 200)))
    if kind == "cold":
        y = t - 1.0 / SQRT2
        return 0.5 * (1.0 + torch.special.erf(y)) + torch.exp(
            -torch.clamp(y * y, max=200.0)
        ) / math.sqrt(2.0 * math.pi)
    if kind == "methfessel_paxton":
        # order-1 MP: reference smearing.cpp evaluates A1*H1(z)*e^{-z^2} at
        # z = -t with A1 = -1/(4 sqrt(pi)), H1(z) = 2z, so the term is
        # +2t e^{-t^2}/(4 sqrt(pi)) in terms of t = (mu - eps)/w.
        e = torch.exp(-torch.clamp(t * t, max=200.0))
        return 0.5 * (1.0 + torch.special.erf(t)) + (2.0 * t) * e / (4.0 * SQRT_PI)
    raise ValueError(f"unknown smearing '{kind}'")


def entropy_term(kind: str, x: torch.Tensor, w: float) -> torch.Tensor:
    """Per-state entropy contribution (reference conventions; sums to the
    'entropy_sum' output; free energy = E_tot + entropy_sum)."""
    t = x / w
    if kind == "gaussian":
        return -torch.exp(-torch.clamp(t * t, max=200.0)) * w / (2.0 * SQRT_PI)
    if kind == "fermi_dirac":
        f = 1.0 / (1.0 + torch.exp(torch.clamp(t, -200, 200)))  # = 1 - occupancy
        fl = torch.clamp(f, 1e-30, 1.0)
        gl = torch.clamp(1.0 - f, 1e-30, 1.0)
        return w * (f * torch.log(fl) + (1.0 - f) * torch.log(gl))
    if kind == "cold":
        y = t - 1.0 / SQRT2
        return -torch.exp(-torch.clamp(y * y, max=200.0)) * (w - SQRT2 * x) / (2.0 * SQRT_PI)
    if kind == "methfessel_paxton":
        # order-1 MP entropy: w (2t^2-1) e^{-t^2} / (4 sqrt(pi)), the QE
        # w1gauss(n=1) form; satisfies s'(x) = x f'(x) against the MP1
        # occupancy above. (reference smearing.cpp:200 has a typo in the
        # recursion coefficient, `i+4` for QE's `i*4`; we follow the
        # thermodynamically consistent QE form.) Unlike the other kinds this
        # term is not negative-definite (positive for |t| > 1/sqrt(2)).
        e = torch.exp(-torch.clamp(t * t, max=200.0))
        return w * (2.0 * t * t - 1.0) * e / (4.0 * SQRT_PI)
    raise ValueError(f"unknown smearing '{kind}'")


def find_fermi_plain(
    evals: torch.Tensor,  # [nk, nspin, nb]
    kweights: torch.Tensor,  # [nk]
    num_electrons: float,
    width: float,
    kind: str = "gaussian",
    max_occupancy: float = 2.0,
    num_iter: int = 80,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bisection for mu such that sum_k w_k sum_{s,b} max_occ * f(mu-e) = N.

    Returns (mu, occupations [nk, nspin, nb], entropy_sum), mu and
    entropy_sum as 0-d tensors on the device of evals."""

    def count(mu):
        f = occupancy(kind, mu - evals, width)
        return torch.sum(kweights[:, None, None] * f) * max_occupancy

    lo = torch.min(evals) - 10.0
    hi = torch.max(evals) + 10.0
    for _ in range(num_iter):
        mid = 0.5 * (lo + hi)
        too_low = count(mid) < num_electrons
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    mu = 0.5 * (lo + hi)
    occ = max_occupancy * occupancy(kind, mu - evals, width)
    ent = max_occupancy * torch.sum(
        kweights[:, None, None] * entropy_term(kind, mu - evals, width)
    )
    return mu, occ, ent


def find_fermi(evals, kweights, num_electrons: float, width: float,
               kind: str = "gaussian", max_occupancy: float = 2.0,
               num_iter: int = 80):
    """Bisection for mu such that sum_k w_k sum_{s,b} max_occ * f(mu-e) = N
    (K13 on a CUDA tensor). Returns (mu, occupations [nk, nspin, nb],
    entropy_sum), mu and entropy_sum as 0-d tensors on the device of
    evals."""
    if kind not in KINDS:
        raise ValueError(f"unknown smearing '{kind}'")
    if evals.dtype != torch.float64 or evals.dim() != 3:
        raise ValueError("evals must be float64 [nk, nspin, nb]")
    nk, ns, nb = evals.shape
    if kweights.dtype != torch.float64 or tuple(kweights.shape) != (nk,):
        raise ValueError(f"kweights must be float64 [{nk}]")
    if kweights.device != evals.device:
        raise ValueError("evals and kweights must be on one device")
    if evals.device.type == "cpu":
        return find_fermi_plain(evals, kweights, num_electrons, width, kind,
                                max_occupancy, num_iter)
    if evals.device.type != "cuda":
        raise RuntimeError(f"find_fermi: unsupported device {evals.device}")
    ev = evals.contiguous()
    occ = torch.empty_like(ev)
    out = torch.empty(2, dtype=torch.float64, device=ev.device)
    lib = build.library("fermi")
    rc = lib.fermi_level(ev.data_ptr(), kweights.contiguous().data_ptr(),
                         ev.numel(), ns * nb, float(num_electrons),
                         float(width), float(max_occupancy), KINDS[kind],
                         int(num_iter), occ.data_ptr(), out.data_ptr(),
                         build.stream_of(ev))
    find_fermi.launches += 1
    build.check(rc, "fermi_level")
    return out[0], occ, out[1]


find_fermi.launches = 0
