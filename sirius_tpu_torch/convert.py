"""Carry state between the JAX package's array layout and the port's.

The tests feed both packages exactly the same operator and start vectors:
they export the JAX objects as numpy arrays and build the port's tensors
from them with these functions. Only numpy crosses the boundary; nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from sirius_tpu_torch.device import resolve_device
from sirius_tpu_torch.ops.beta_chunked import (ChunkedParams,
                                               chunked_params_from_arrays)
from sirius_tpu_torch.ops.gamma import GammaParams, gamma_params_from_arrays
from sirius_tpu_torch.parallel.batched import HkSetParams, hkset_from_arrays
from sirius_tpu_torch.parallel.batched_nc import NcSetParams

HKSET_KEYS = ("veff_r", "ekin", "mask", "fft_index", "beta_re", "beta_im",
              "dion", "qmat", "h_diag", "o_diag")
GAMMA_KEYS = ("veff_r", "ekin_p", "mask_p", "fft_index", "slot_re",
              "slot_im", "im_sign", "scale", "zero_idx", "beta_p", "dion",
              "qmat")
NC_SET_KEYS = ("veff_uu", "veff_dd", "bx", "by", "ekin", "mask", "fft_index",
               "beta_re", "beta_im", "dmat_re", "dmat_im", "qmat_re",
               "qmat_im", "h_diag", "o_diag")
CHUNKED_KEYS = ("ekin", "mask", "fft_index", "veff_r", "dmat", "qmat_c",
                "pos", "xi_rf", "xi_lm", "cph_re", "cph_im", "rlm", "q", "mk",
                "ri_grid", "dq", "pref")


def _take(arrays: dict, keys, what: str) -> dict:
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"missing {what} leaves: {missing}")
    return {k: np.asarray(arrays[k]) for k in keys}


def hkset_from_numpy(arrays: dict, device) -> HkSetParams:
    """The port's batched H parameters from the JAX HkSetParams leaves
    (numpy arrays under HKSET_KEYS; beta as its (re, im) pair). A polarized
    set carries its spin axis as the JAX one does: veff_r [ns, ...], dion
    [ns, nbeta, nbeta], h_diag [nk, ns, ngk]."""
    a = _take(arrays, HKSET_KEYS, "HkSetParams")
    a["beta"] = a.pop("beta_re") + 1j * a.pop("beta_im")
    return hkset_from_arrays(a, device)


def nc_set_from_numpy(arrays: dict, device) -> NcSetParams:
    """The port's spinor k-set parameters from the JAX NcSetParams leaves
    (numpy arrays under NC_SET_KEYS; the complex tables as (re, im) pairs,
    the four coarse boxes apart). The projectors are masked here, as
    make_nc_set_params masks them."""
    device = resolve_device(device)
    a = _take(arrays, NC_SET_KEYS, "NcSetParams")

    def t(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    f64, c128 = torch.float64, torch.complex128
    mask = t(a["mask"], f64)
    return NcSetParams(
        veff=t(np.stack([a["veff_uu"], a["veff_dd"], a["bx"], a["by"]]), f64),
        ekin=t(a["ekin"], f64), mask=mask,
        fft_index=t(a["fft_index"], torch.int32),
        beta=t(a["beta_re"] + 1j * a["beta_im"], c128) * mask[:, None, :],
        dmat=t(a["dmat_re"] + 1j * a["dmat_im"], c128),
        qmat=t(a["qmat_re"] + 1j * a["qmat_im"], c128),
        h_diag=t(a["h_diag"], f64), o_diag=t(a["o_diag"], f64))


def nc_state_from_numpy(psi, x_mix, ng: int, device):
    """A JAX non-collinear SCF state as the port's tensors: the flattened
    spinors [nk, nb, 2 ngk] and the mixed vector [rho; m_x; m_y; m_z]
    [4 ng], returned as (psi, rho_g [ng], mvec_g [3, ng])."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x_mix, dtype=np.complex128), device=device)
    if x.shape != (4 * ng,):
        raise ValueError(f"mixed vector of {tuple(x.shape)}, want [{4 * ng}]")
    return (torch.as_tensor(np.asarray(psi, dtype=np.complex128),
                            device=device), x[:ng], x[ng:].reshape(3, ng))


def gamma_params_from_numpy(arrays: dict, device) -> GammaParams:
    """The port's packed-real H parameters from the JAX GammaParams leaves
    (numpy arrays under GAMMA_KEYS)."""
    return gamma_params_from_arrays(_take(arrays, GAMMA_KEYS, "GammaParams"),
                                    device)


def gamma_spin_params_from_numpy(arrays: dict, veff_r, dion,
                                 device) -> list[GammaParams]:
    """One GammaParams per spin channel, as the JAX package's polarized
    Gamma solve makes them (scf.py:1400-1403): the constant leaves of
    ``arrays`` (GAMMA_KEYS) with that spin's potential veff_r[ispn] and
    screened D dion[ispn] swapped in. veff_r [ns, n1, n2, n3], dion
    [ns, nbeta, nbeta]."""
    a = _take(arrays, GAMMA_KEYS, "GammaParams")
    veff_r, dion = np.asarray(veff_r), np.asarray(dion)
    if veff_r.shape[0] != dion.shape[0]:
        raise ValueError("veff_r and dion disagree on the spin count")
    return [gamma_params_from_arrays(dict(a, veff_r=v, dion=d), device)
            for v, d in zip(veff_r, dion)]


def chunked_params_from_numpy(arrays: dict, device) -> ChunkedParams:
    """The port's chunked-projector H parameters from the JAX
    make_chunked_hk dict (numpy arrays under CHUNKED_KEYS; the (-i)^l
    prefactors as their (re, im) pair)."""
    a = _take(arrays, CHUNKED_KEYS, "make_chunked_hk")
    a["cph"] = a.pop("cph_re") + 1j * a.pop("cph_im")
    return chunked_params_from_arrays(a, device)


def packed_from_numpy(x: np.ndarray, device) -> torch.Tensor:
    """A packed-real Gamma block [..., ngk] as a float64 tensor."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=resolve_device(device))


def mgga_from_numpy(vtau_r, gkcart, device):
    """The JAX tau operator's inputs as the port's: v_tau [ns, n1, n2, n3]
    (a single [n1, n2, n3] box becomes ns = 1) and the Cartesian G+k
    components [..., ngk, 3], both float64 tensors."""
    device = resolve_device(device)
    vtau = np.asarray(vtau_r, dtype=np.float64)
    if vtau.ndim == 3:
        vtau = vtau[None]
    return (torch.as_tensor(vtau, device=device),
            torch.as_tensor(np.asarray(gkcart, dtype=np.float64),
                            device=device))


def context_arrays(ctx) -> dict:
    """A context's tables under the names the JAX context uses (works on
    either package's SimulationContext: attribute access only)."""
    out = {
        "gvec.millers": ctx.gvec.millers,
        "gvec.gcart": ctx.gvec.gcart,
        "gvec.glen2": ctx.gvec.glen2,
        "gvec.shell_idx": ctx.gvec.shell_idx,
        "gvec.fft_index": ctx.gvec.fft_index,
        "gvec.fft.dims": np.asarray(ctx.gvec.fft.dims),
        "gvec_coarse.millers": ctx.gvec_coarse.millers,
        "gvec_coarse.fft_index": ctx.gvec_coarse.fft_index,
        "fft_coarse.dims": np.asarray(ctx.fft_coarse.dims),
        "coarse_to_fine": ctx.coarse_to_fine,
        "gkvec.kpoints": ctx.gkvec.kpoints,
        "gkvec.weights": ctx.gkvec.weights,
        "gkvec.num_gk": ctx.gkvec.num_gk,
        "gkvec.millers": ctx.gkvec.millers,
        "gkvec.gkcart": ctx.gkvec.gkcart,
        "gkvec.mask": ctx.gkvec.mask,
        "gkvec.fft_index": ctx.gkvec.fft_index,
        "gkvec.kinetic": ctx.gkvec.kinetic(),
        "kweights": ctx.kweights,
        "beta.beta_gk": ctx.beta.beta_gk,
        "beta.dion": ctx.beta.dion,
        "vloc_g": ctx.vloc_g,
        "rho_core_g": ctx.rho_core_g,
        "rho_atomic_g": ctx.rho_atomic_g,
        "e_ewald": np.asarray(ctx.e_ewald),
        "num_bands": np.asarray(ctx.num_bands),
        "num_spins": np.asarray(ctx.num_spins),
        "omega": np.asarray(ctx.unit_cell.omega),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def psi_from_numpy(psi: np.ndarray, device) -> torch.Tensor:
    """A wave-function block [..., ngk] or rho(G) on the fine G set as a
    complex128 tensor."""
    return torch.as_tensor(np.asarray(psi, dtype=np.complex128),
                           device=resolve_device(device))


density_from_numpy = psi_from_numpy
