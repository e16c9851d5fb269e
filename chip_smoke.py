"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of sirius_tpu. Phases, each printing JSON lines:

1. device and build: the card's name and power limit; the kernel sources
   of sirius_tpu_torch/csrc/ compiled by nvcc, one process each, all at
   once;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the parity decks and of the full-width decks (norm-conserving: K1,
   K2, K3, K7; ultrasoft + symmetry: K1c, K4, K5, K6): error, kernel time
   (CUDA events, median of 21 samples of 5 launches after warm-up), the
   plain version's time, a one-call PyTorch yardstick where one exists
   (library_ms), and the least time the card could take (bound_ms);
3. parity SCF: the 2-atom full-width decks, norm-conserving without
   symmetry (parity_scf) and ultrasoft with the space group
   (parity_scf_us), against the JAX package's recorded energies
   (sirius_tpu_torch/data/jax_reference.json);
4. full-width runs: the 16-atom Si supercell, norm-conserving (full_width,
   3 SCF iterations) and ultrasoft with its 384 space-group ops
   (full_width_us, 6 iterations), with tolerances that cannot be met, so
   every iteration runs; kernel launches per iteration, peak device memory,
   electron count, finite energies.

Every SCF phase sets the launch counts to 0 just before its run and reads
them just after; the kernels summary takes its launches from full_width_us,
which runs every kernel.

The last three lines are the kernels summary, the nvidia-smi name/power
line and {"ok": true, "device": {...}}. Any failure exits non-zero before
the ok line; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory and fp64 outside the
# tensor cores, the rate of these kernels' elementwise fp64 work
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12

TIGHT = {"num_dft_iter": 40, "density_tol": 5e-9, "energy_tol": 1e-10}
PARITY = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2))
FULL = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(2, 2, 2), supercell=2)
NC = dict(ultrasoft=False, use_symmetry=False)
US_SYM = dict(ultrasoft=True, use_symmetry=True)
FULL_ITERS = {"full_width": 3, "full_width_us": 6}
FULL_ELECTRONS = 64.0
# relative tolerance of each kernel against its plain version on the card:
# K1/K2 are a store/gather and three fixed-order row sums (rounding only);
# K3 sums |psi|^2 over bands and K7 evaluates pow/cbrt/log in closed form
# against autograd of the same expression, a few ulp more
# K1c multiplies (rounding only); K4/K5 sum over atoms, pairs and G with
# sincospi phases against dense exp() phases; K6 sums the ops in the same
# order as its plain version, phases again sincospi against exp()
TOL = {"local_hpsi.pw_to_box": 1e-12, "local_hpsi.box_to_pw_hpsi": 1e-12,
       "davidson_residual": 1e-12, "density_accumulate": 1e-11,
       "lda_xc": 1e-11, "veff_multiply": 1e-12,
       "augmentation.rho_aug": 1e-12, "augmentation.d_operator": 1e-12,
       "symmetrize_pw": 1e-13}
SOURCE = {
    "local_hpsi.pw_to_box": "sirius_tpu_torch/csrc/local_hpsi.cu",
    "local_hpsi.box_to_pw_hpsi": "sirius_tpu_torch/csrc/local_hpsi.cu",
    "davidson_residual": "sirius_tpu_torch/csrc/davidson_residual.cu",
    "density_accumulate": "sirius_tpu_torch/csrc/density_accumulate.cu",
    "lda_xc": "sirius_tpu_torch/csrc/lda_xc.cu",
    "veff_multiply": "sirius_tpu_torch/csrc/veff_multiply.cu",
    "augmentation.rho_aug": "sirius_tpu_torch/csrc/augmentation.cu",
    "augmentation.d_operator": "sirius_tpu_torch/csrc/augmentation.cu",
    "symmetrize_pw": "sirius_tpu_torch/csrc/symmetrize_pw.cu",
}
REPLACES = {
    "local_hpsi.pw_to_box": "sirius_tpu/ops/hamiltonian.py:76",
    "local_hpsi.box_to_pw_hpsi": "sirius_tpu/ops/hamiltonian.py:78",
    "davidson_residual": "sirius_tpu/solvers/davidson.py:141",
    "density_accumulate": "sirius_tpu/parallel/batched.py:343",
    "lda_xc": "sirius_tpu/dft/xc.py:341",
    "veff_multiply": "sirius_tpu/ops/hamiltonian.py:81",
    "augmentation.rho_aug": "sirius_tpu/ops/augmentation.py:250",
    "augmentation.d_operator": "sirius_tpu/ops/augmentation.py:266",
    "symmetrize_pw": "sirius_tpu/dft/density.py:348",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, samples: int = 21, inner: int = 5, warm: int = 3) -> float:
    """Median over samples of the mean time of `inner` back-to-back calls,
    between CUDA events on the current stream."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP64_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(a, b) -> tuple[float, float]:
    import torch

    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / scale if scale > 0 else err


def record_kernel(out, deck, gpu, name, kernel_out, plain_out, fn_k, fn_p,
                  fn_lib, nbytes, flops, slow_plain=False):
    """Compare one kernel with its plain version, time both (and the
    library yardstick), emit the record and keep it in out[name]."""
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)
            if a is not None]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ms = time_ms(fn_k)
    # a plain version that loops in Python is timed over fewer samples
    plain_ms = (time_ms(fn_p, samples=5, inner=1, warm=1) if slow_plain
                else time_ms(fn_p))
    lib_ms = time_ms(fn_lib) if fn_lib is not None else None
    b_ms, b_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "deck": deck, "name": name, "gpu": gpu,
           "max_abs_err": abs_err, "max_rel_err": rel, "tol_rel": TOL[name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    emit(rec)
    if not rel <= TOL[name]:
        raise AssertionError(f"{name} at {deck}: rel err {rel} > {TOL[name]}")
    out[name] = rec


def make_context(spec: dict, extra: dict | None = None, kind: dict = NC):
    from sirius_tpu_torch.testing import synthetic_silicon_context

    return synthetic_silicon_context(extra_params=dict(extra or {}), **kind,
                                     **spec)


def check_kernels(deck: str, ctx, dev, gpu: str) -> dict:
    """Each kernel against its plain version at this deck's main-path
    shapes. Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.core.fftgrid import g_to_r
    from sirius_tpu_torch.dft.density import grid_tables, initial_density_g
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import density_accumulate as k3
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import local_hpsi as k1
    from sirius_tpu_torch.ops.hamiltonian import apply_h_s
    from sirius_tpu_torch.parallel.batched import make_hkset_params

    nk, nb, ngk = ctx.gkvec.num_kpoints, ctx.num_bands, ctx.gkvec.ngk_max
    dims = tuple(ctx.fft_coarse.dims)
    n = int(np.prod(dims))
    nfine = int(np.prod(ctx.gvec.fft.dims))
    rng = np.random.default_rng(7)
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)
    ps = make_hkset_params(ctx, pot.veff_r_coarse.cpu().numpy(), device=dev)
    hk = ps.hk()
    mask = hk.mask
    psi_np = (rng.standard_normal((nk, nb, ngk))
              + 1j * rng.standard_normal((nk, nb, ngk)))
    psi = torch.as_tensor(psi_np, device=dev)  # padded lanes hold garbage
    idx = hk.fft_index
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)

    # K1a: sphere -> box scatter at the Davidson step shape [nk, nb, ngk]
    box_k = k1.pw_to_box(psi, idx, mask, n)
    box_p = k1.pw_to_box_plain(psi, idx, mask, n)
    valid = (mask > 0)
    bi, gi = torch.nonzero(valid, as_tuple=True)
    rows = (bi[:, None] * nb + torch.arange(nb, device=dev)[None, :]).reshape(-1)
    cols = idx[bi, gi].long().repeat_interleave(nb)
    vals = psi.permute(0, 2, 1)[bi, gi].reshape(-1)

    def lib_scatter():
        z = torch.zeros((nk * nb, n), dtype=torch.complex128, device=dev)
        return z.index_put_((rows, cols), vals)

    record("local_hpsi.pw_to_box", [box_k], [box_p],
           lambda: k1.pw_to_box(psi, idx, mask, n),
           lambda: k1.pw_to_box_plain(psi, idx, mask, n), lib_scatter,
           nbytes=nk * nb * ngk * 16 + nk * ngk * 12 + nk * nb * n * 16,
           flops=0.0)
    del box_p

    # K1b: box -> sphere gather fused with ekin*psi and the mask
    vbox = torch.fft.fftn(box_k.view((nk, nb) + dims), dim=(-3, -2, -1)).view(nk, nb, n)
    del box_k
    h_k = k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx)
    h_p = k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx)
    gidx = idx.long()[:, None, :].expand(nk, nb, ngk)
    record("local_hpsi.box_to_pw_hpsi", list(h_k), list(h_p),
           lambda: k1.box_to_pw_hpsi(vbox, psi, hk.ekin, mask, idx),
           lambda: k1.box_to_pw_hpsi_plain(vbox, psi, hk.ekin, mask, idx),
           lambda: torch.gather(vbox, 2, gidx),
           nbytes=nk * nb * ngk * (16 + 16 + 32) + nk * ngk * 20,
           flops=nk * nb * ngk * 8.0)
    del vbox, h_k, h_p

    # K2: residual + preconditioner on a real (x, Hx, Sx); row 0 of each
    # k-point is an exact eigenpair so the converged branch is exercised
    x = psi * mask[:, None, :]
    hx, sx = apply_h_s(hk, x)
    hx[:, 0] = 2.0 * sx[:, 0]
    hd = ps.h_diag.reshape(nk, ngk)
    od = ps.o_diag
    r_k = k2.davidson_residual(x, hx, sx, hd, od, mask, 1e-6)
    r_p = k2.davidson_residual_plain(x, hx, sx, hd, od, mask, 1e-6)
    if not bool((r_k[1][:, 0] < 1e-6).all()):
        raise AssertionError("davidson_residual: eigenpair rows not converged")
    record("davidson_residual", list(r_k), list(r_p),
           lambda: k2.davidson_residual(x, hx, sx, hd, od, mask, 1e-6),
           lambda: k2.davidson_residual_plain(x, hx, sx, hd, od, mask, 1e-6),
           None,
           nbytes=nk * nb * ngk * (48 + 16) + nk * ngk * 24 + nk * nb * 16,
           flops=nk * nb * ngk * 30.0)
    del x, hx, sx, r_k, r_p

    # K3: |psi(r)|^2 accumulation of one k-point's box, [1, nb, N]
    box = k1.pw_to_box(psi[:1], idx[:1], mask[:1], n)
    fr = torch.fft.ifftn(box.view((1, nb) + dims), dim=(-3, -2, -1)).view(1, nb, n)
    del box
    occ = torch.as_tensor(rng.uniform(0.0, 0.25, (1, nb)), device=dev)
    acc0 = torch.as_tensor(rng.uniform(0.0, 1.0, (1, n)), device=dev)
    a_k = k3.density_accumulate(acc0.clone(), fr, occ, float(n) ** 2)
    a_p = k3.density_accumulate_plain(acc0.clone(), fr, occ, float(n) ** 2)
    acc_t = acc0.clone()
    record("density_accumulate", [a_k], [a_p],
           lambda: k3.density_accumulate(acc_t, fr, occ, float(n) ** 2),
           lambda: k3.density_accumulate_plain(acc_t, fr, occ, float(n) ** 2),
           None, nbytes=nb * n * 16 + n * 16 + nb * 8, flops=nb * n * 4.0)
    del fr

    # K7: unpolarized X + PZ on the initial density's fine box, with
    # exactly-zero and sub-threshold points
    rho_r = g_to_r(rho0, tables.fft_index, tables.dims).real.reshape(-1).clone()
    rho_r[:64] = 0.0
    rho_r[64:128] = 1e-14
    x_k = k7.lda_xc_unpolarized(rho_r)
    x_p = k7.lda_xc_unpolarized_plain(rho_r)
    record("lda_xc", list(x_k), list(x_p),
           lambda: k7.lda_xc_unpolarized(rho_r),
           lambda: k7.lda_xc_unpolarized_plain(rho_r), None,
           nbytes=nfine * 24, flops=nfine * 60.0)
    return out


def check_kernels_us(deck: str, ctx, dev, gpu: str) -> dict:
    """K1c, K4, K5 and K6 against their plain versions at an ultrasoft +
    symmetry deck's main-path shapes. Returns {kernel: record}."""
    import numpy as np
    import torch

    from sirius_tpu_torch.dft.density import (build_sym_pw_tables, grid_tables,
                                              initial_density_g)
    from sirius_tpu_torch.dft.potential import generate_potential
    from sirius_tpu_torch.dft.xc import XCFunctional
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import symmetrize_pw as k6
    from sirius_tpu_torch.kernels import veff_multiply as k1c
    from sirius_tpu_torch.ops.augmentation import build_aug_device_tables

    nk, nb = ctx.gkvec.num_kpoints, ctx.num_bands
    n = int(np.prod(ctx.fft_coarse.dims))
    ng = ctx.gvec.num_gvec
    nbeta = ctx.beta.num_beta_total
    omega = float(ctx.unit_cell.omega)
    rng = np.random.default_rng(11)
    out = {}
    record = functools.partial(record_kernel, out, deck, gpu)
    tables = grid_tables(ctx, dev)
    rho0 = torch.as_tensor(initial_density_g(ctx), device=dev)
    pot = generate_potential(ctx, rho0, XCFunctional(["XC_LDA_X", "XC_LDA_C_PZ"]),
                             tables)

    # K1c: one application to [X; P] of the band solve, B = nk, R = 2 nb
    rows = 2 * nb
    veff = pot.veff_r_coarse.reshape(1, n)
    fr0 = torch.complex(torch.randn(nk, rows, n, dtype=torch.float64, device=dev),
                        torch.randn(nk, rows, n, dtype=torch.float64, device=dev))
    fr_k = k1c.veff_multiply(fr0.clone(), veff)
    fr_p = k1c.veff_multiply_plain(fr0.clone(), veff)
    fr_t = fr0.clone()
    record("veff_multiply", [fr_k], [fr_p],
           lambda: k1c.veff_multiply(fr_t, veff),
           lambda: k1c.veff_multiply_plain(fr_t, veff),
           lambda: fr_t.mul_(veff[None]),
           nbytes=nk * rows * n * 32 + n * 8, flops=nk * rows * n * 2.0)
    del fr0, fr_k, fr_p, fr_t

    # K4 / K5: one atom type; a Hermitian density matrix and the potential
    # of the initial density
    aug = build_aug_device_tables(ctx.unit_cell, ctx.gvec, ctx.aug, ctx.beta,
                                  dev)[0]
    na, nqlm = aug["pos"].shape[0], aug["q"].shape[0]
    a = rng.standard_normal((nbeta, nbeta)) + 1j * rng.standard_normal((nbeta, nbeta))
    dm = torch.as_tensor((a + a.conj().T)[None] * 0.05, device=dev)
    targs = (aug["gidx"], aug["w"], aug["millers"], aug["pos"], aug["q"])
    ph = k45.structure_phases(aug["millers"], aug["pos"])
    dmp = (aug["w"][None, None, :] * dm.reshape(1, -1)[:, aug["gidx"].long()].real
           ).to(torch.complex128)
    record("augmentation.rho_aug", [k45.rho_aug(dm, *targs)],
           [k45.rho_aug_plain(dm, *targs)],
           lambda: k45.rho_aug(dm, *targs),
           lambda: k45.rho_aug_plain(dm, *targs),
           lambda: torch.einsum("ga,saq,qg->sg", ph, dmp, aug["q"]),
           nbytes=nqlm * ng * 16 + ng * 16 + ng * 12 + nbeta * nbeta * 16,
           flops=ng * (na * (5.0 + 2.0 + nqlm * 4.0) + nqlm * 8.0))
    v = pot.veff_g.contiguous()
    dion = torch.as_tensor(ctx.beta.dion, dtype=torch.float64, device=dev)
    dargs = (aug["millers"], aug["pos"], aug["q"], aug["gidx"], aug["lo_idx"],
             aug["lo_mask"], omega)
    d_t = dion.clone()
    record("augmentation.d_operator",
           [k45.d_operator(v, *dargs, dion.clone())],
           [k45.d_operator_plain(v, *dargs, dion.clone())],
           lambda: k45.d_operator(v, *dargs, d_t),
           lambda: k45.d_operator_plain(v, *dargs, d_t),
           lambda: torch.einsum("qg,g,ga->aq", aug["q"], v.conj(), ph),
           nbytes=nqlm * ng * 16 + ng * 16 + ng * 12 + 2 * nbeta * nbeta * 8,
           flops=ng * na * (5.0 + 2.0 + 6.0 + nqlm * 4.0))
    del ph, dmp

    # K6: the rho_new symmetrization of the SCF (a scalar field), on the
    # initial density; yardstick: index_add_ over the JAX package's dense
    # per-op scatter table
    tb = tables.sym if tables.sym is not None else build_sym_pw_tables(ctx, dev)
    f = rho0.contiguous()
    sargs = (tb.millers, tb.lut, tb.rot, tb.trans, tb.dims)
    nops = tb.num_ops
    n1, n2, n3 = tb.dims
    m = tb.millers.long()
    idx = torch.empty((nops, ng), dtype=torch.int64, device=dev)
    x = m.to(torch.float64) @ tb.trans.T  # [ng, nops]: target phases
    arange = torch.arange(ng, device=dev)
    for op in range(nops):
        src, _ = k6.source_index(m, tb.rot[op], tb.lut, tb.dims)
        idx[op].scatter_(0, src, arange)  # source -> target
    vals = (f[None, :] * torch.polar(torch.ones_like(x.T),
                                     -2.0 * math.pi * x.T.gather(1, idx))
            ).reshape(-1)
    idx = idx.reshape(-1)
    del x

    def lib_sym():
        return torch.zeros_like(f).index_add_(0, idx, vals) / nops

    record("symmetrize_pw", [k6.symmetrize_pw(f, *sargs)],
           [k6.symmetrize_pw_plain(f, *sargs)],
           lambda: k6.symmetrize_pw(f, *sargs),
           lambda: k6.symmetrize_pw_plain(f, *sargs), lib_sym,
           nbytes=ng * (16 + 12 + 16) + n1 * n2 * n3 * 4 + nops * 60,
           flops=nops * ng * 15.0, slow_plain=True)
    del idx, vals
    return out


def wrappers() -> dict:
    """The kernel wrappers by summary name; each carries a launch count."""
    from sirius_tpu_torch.kernels import augmentation as k45
    from sirius_tpu_torch.kernels import davidson_residual as k2
    from sirius_tpu_torch.kernels import density_accumulate as k3
    from sirius_tpu_torch.kernels import lda_xc as k7
    from sirius_tpu_torch.kernels import local_hpsi as k1
    from sirius_tpu_torch.kernels import symmetrize_pw as k6
    from sirius_tpu_torch.kernels import veff_multiply as k1c

    return {"local_hpsi.pw_to_box": k1.pw_to_box,
            "local_hpsi.box_to_pw_hpsi": k1.box_to_pw_hpsi,
            "davidson_residual": k2.davidson_residual,
            "density_accumulate": k3.density_accumulate,
            "lda_xc": k7.lda_xc,
            "veff_multiply": k1c.veff_multiply,
            "augmentation.rho_aug": k45.rho_aug,
            "augmentation.d_operator": k45.d_operator,
            "symmetrize_pw": k6.symmetrize_pw}


# the kernels each SCF path must launch: the norm-conserving path runs K1,
# K1c, K2, K3 and K7; ultrasoft + symmetry adds K4, K5 and K6
NC_KERNELS = ("local_hpsi.pw_to_box", "local_hpsi.box_to_pw_hpsi",
              "davidson_residual", "density_accumulate", "lda_xc",
              "veff_multiply")
US_KERNELS = NC_KERNELS + ("augmentation.rho_aug", "augmentation.d_operator",
                           "symmetrize_pw")


def reset_launches() -> None:
    for f in wrappers().values():
        f.launches = 0


def read_launches() -> dict:
    return {name: f.launches for name, f in wrappers().items()}


def check_launched(phase: str, dev, launches: dict, required) -> None:
    """Fail unless every kernel of the path launched in this run. On the
    CPU the wrappers take their plain versions and count nothing."""
    zero = [k for k in required if launches[k] <= 0]
    if dev.type == "cuda" and zero:
        raise AssertionError(f"{phase}: kernels never launched: {zero}")


def parity_scf(ctx, dev, ref: dict, gpu: str, phase: str = "parity_scf",
               deck: str = "full_width_2atom",
               required=NC_KERNELS) -> None:
    from sirius_tpu_torch.dft.scf import run_scf

    reset_launches()
    res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    d_total = res["energy"]["total"] - ref["energy"]["total"]
    terms = {k: res["energy"][k] - v for k, v in ref["energy"].items()}
    emit({"phase": phase, "gpu": gpu, "deck": deck,
          "num_scf_iterations": res["num_scf_iterations"],
          "ref_iterations": ref["num_scf_iterations"],
          "e_total": res["energy"]["total"], "d_total": d_total,
          "max_term_err": max(abs(v) for v in terms.values()),
          "efermi": res["efermi"], "efermi_err": res["efermi"] - ref["efermi"],
          "iteration_seconds": res["iteration_seconds"],
          "band_solve_seconds": res["band_solve_seconds"],
          "launches": launches})
    if abs(d_total) > 1e-8:
        raise AssertionError(f"{phase}: |dE_total| = {abs(d_total)} > 1e-8 Ha")
    bad = {k: v for k, v in terms.items() if abs(v) > 1e-8}
    if bad:
        raise AssertionError(f"{phase}: energy terms off by > 1e-8 Ha: {bad}")
    if abs(res["num_scf_iterations"] - ref["num_scf_iterations"]) > 1:
        raise AssertionError(f"{phase}: iteration count differs by more than 1")
    check_launched(phase, dev, launches, required)


def full_width(ctx, dev, gpu: str, phase: str = "full_width",
               required=NC_KERNELS) -> dict:
    import torch

    from sirius_tpu_torch.dft.scf import run_scf

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_scf(ctx.cfg, ctx=ctx, device=dev)
    launches = read_launches()
    iters = res["num_scf_iterations"]
    nel = float(res["_state"]["rho_g"][0].real) * ctx.unit_cell.omega
    e_ok = all(math.isfinite(v) for v in res["energy"].values())
    emit({"phase": phase, "gpu": gpu, "deck": "si16_supercell2",
          "ultrasoft": ctx.aug is not None,
          "num_symmetry_ops": (0 if ctx.symmetry is None
                               else ctx.symmetry.num_ops),
          "num_bands": ctx.num_bands, "ngk_max": int(ctx.gkvec.ngk_max),
          "num_kpoints": ctx.gkvec.num_kpoints,
          "coarse_box": list(ctx.fft_coarse.dims),
          "fine_box": list(ctx.gvec.fft.dims), "num_gvec": ctx.gvec.num_gvec,
          "num_beta": ctx.beta.num_beta_total, "num_scf_iterations": iters,
          "iteration_seconds": res["iteration_seconds"],
          "band_solve_seconds": res["band_solve_seconds"],
          "launches": launches,
          "launches_per_iteration": {k: v / iters for k, v in launches.items()},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "electrons": nel, "e_total": res["energy"]["total"],
          "energies_finite": e_ok})
    if iters != FULL_ITERS[phase]:
        raise AssertionError(f"{phase}: {iters} iterations, want "
                             f"{FULL_ITERS[phase]}")
    if not e_ok:
        raise AssertionError(f"{phase}: non-finite energy")
    if abs(nel - FULL_ELECTRONS) > 1e-8:
        raise AssertionError(f"{phase}: electron count {nel}")
    check_launched(phase, dev, launches, required)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import sirius_tpu_torch
    from sirius_tpu_torch.kernels import build

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        sirius_tpu_torch.__file__)))
    if pkg_root != here:
        print(f"chip_smoke: sirius_tpu_torch found at {pkg_root}, not beside "
              "this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    gpu = f"{torch.cuda.get_device_name(0)} ({smi})"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    compiled = build.build_all()
    emit({"phase": "build", "gpu": gpu, "nvcc": build.nvcc_path(),
          "seconds": time.perf_counter() - t0, "compiled": compiled})

    with open(os.path.join(here, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        refs = json.load(f)["decks"]
    t0 = time.perf_counter()
    run_to_end = {"density_tol": 0.0, "energy_tol": 0.0}
    ctx2 = make_context(PARITY, TIGHT)
    ctx16 = make_context(FULL, {"num_dft_iter": FULL_ITERS["full_width"],
                                **run_to_end})
    ctx2us = make_context(PARITY, TIGHT, US_SYM)
    ctx16us = make_context(FULL, {"num_dft_iter": FULL_ITERS["full_width_us"],
                                  **run_to_end}, US_SYM)
    emit({"phase": "contexts", "seconds": time.perf_counter() - t0})

    check_kernels("full_width_2atom", ctx2, dev, gpu)
    kern16 = check_kernels("si16_supercell2", ctx16, dev, gpu)
    check_kernels_us("full_width_2atom_us_sym", ctx2us, dev, gpu)
    kern16.update(check_kernels_us("si16_supercell2_us_sym", ctx16us, dev, gpu))
    torch.cuda.empty_cache()
    parity_scf(ctx2, dev, refs["full_width_2atom"], gpu)
    full_width(ctx16, dev, gpu)
    parity_scf(ctx2us, dev, refs["full_width_2atom_us_sym"], gpu,
               phase="parity_scf_us", deck="full_width_2atom_us_sym",
               required=US_KERNELS)
    launches = full_width(ctx16us, dev, gpu, phase="full_width_us",
                          required=US_KERNELS)

    summary = []
    for name, rec in kern16.items():
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
