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
from sirius_tpu_torch.parallel.batched import HkSetParams, hkset_from_arrays

HKSET_KEYS = ("veff_r", "ekin", "mask", "fft_index", "beta_re", "beta_im",
              "dion", "qmat", "h_diag", "o_diag")


def hkset_from_numpy(arrays: dict, device) -> HkSetParams:
    """The port's batched H parameters from the JAX HkSetParams leaves
    (numpy arrays under HKSET_KEYS; beta as its (re, im) pair)."""
    missing = [k for k in HKSET_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing HkSetParams leaves: {missing}")
    a = {k: np.asarray(arrays[k]) for k in HKSET_KEYS}
    a["beta"] = a.pop("beta_re") + 1j * a.pop("beta_im")
    return hkset_from_arrays(a, device)


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
