"""Port parity for the fp32 wave-function path (precision_wf = "fp32"):
complex64 / float32 blocks with float32 tables, against the JAX package's
own complex64 / float32 functions on the CPU and against the port's
complex128 result, from numpy inputs made with a fixed seed:
- every module that holds a band-solve or density kernel: apply_h_s (K1,
  K1c), apply_h_s_gamma (K8a, K1c real, K8b), apply_h_s_chunked (K9),
  apply_h_s_mgga (K11a, K11b), apply_h_s_nc (K12a), density_kset (K3),
  tau_kset (K11a, K3), density_kset_nc (K12b) and one Davidson residual
  step (K2 on complex64 and on float32 packed blocks), each through its
  kernels' plain versions, the tables through convert.py;
- the kernels' fp32 instantiations: their C entry points and ctypes
  signatures, and the refusal of mixed types;
- run_scf on the deck of tests/test_precision.py against the JAX package's
  records (sirius_tpu_torch/data/jax_reference.json): pure fp32, fp32 with
  the fp32_to_fp64_rms polish, and fp32 at a fixed count; and every band-
  solve path in fp32.
Bounds: operators 1e-5 relative to the largest magnitude of each output
(measured: at most 1.5e-6 against the JAX package's complex64 result and
1.2e-6 against the port's complex128 one, both the Davidson step's
preconditioned block; the H applications and densities ~1e-7); pure fp32
within 5e-5 Ha of the JAX package's fp64 total; fp32 + polish every term
and the electron count within 1e-8 of its fp64 record, at +-1 of the JAX
package's polished iteration count; fp32 at a fixed count every term and
the electron count within 4x the JAX package's own largest fp32-vs-fp64
gap over its three fp32 runs of the deck (the record and two from starts
perturbed by 1e-7), the terms at most 1e-4 Ha (measured: 8.3e-6 Ha in
kin). The JAX package's own fp32 runs miss the electron count by up to
2e-6 (its fp32 bands are S-normalized to fp32 rounding), so no 1e-8
electron gate is put on pure fp32."""

import importlib.util
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.ops import beta_chunked as jb
from sirius_tpu.ops import gamma as jg
from sirius_tpu.ops import mgga as jax_mgga
from sirius_tpu.ops import spinor as jspinor
from sirius_tpu.ops.hamiltonian import apply_h_s as jax_apply_h_s
from sirius_tpu.parallel import batched_nc as jbnc
from sirius_tpu.parallel.batched import density_kset as jax_density_kset
from sirius_tpu.parallel.batched import hk_complex, hkset_slice_r
from sirius_tpu.parallel.batched import make_hkset_params as jax_hkset
from sirius_tpu.testing import synthetic_silicon_context as jax_context
from sirius_tpu_torch import convert
from sirius_tpu_torch.dft.scf import band_solve_path, run_scf
from sirius_tpu_torch.kernels import beta_chunk as k9
from sirius_tpu_torch.kernels import build
from sirius_tpu_torch.kernels import davidson_residual as k2
from sirius_tpu_torch.kernels import density_accumulate as k3
from sirius_tpu_torch.kernels import gamma_pack as k8
from sirius_tpu_torch.kernels import local_hpsi as k1
from sirius_tpu_torch.kernels import mgga_tau as k11
from sirius_tpu_torch.kernels import spinor_veff as k12a
from sirius_tpu_torch.kernels import veff_multiply as k1c
from sirius_tpu_torch.ops import beta_chunked as tb
from sirius_tpu_torch.ops import gamma as tg
from sirius_tpu_torch.ops import spinor as tspinor
from sirius_tpu_torch.ops.hamiltonian import apply_h_s
from sirius_tpu_torch.ops.mgga import apply_h_s_mgga, tau_kset
from sirius_tpu_torch.parallel import batched_nc as tbnc
from sirius_tpu_torch.parallel.batched import density_kset
from sirius_tpu_torch.solvers import davidson as tdav
from sirius_tpu_torch.testing import synthetic_silicon_context as port_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C64, C128, F32, F64 = (torch.complex64, torch.complex128, torch.float32,
                       torch.float64)
SMALL = dict(gk_cutoff=3.0, pw_cutoff=7.0, ngridk=(2, 2, 2), num_bands=8)
US = dict(ultrasoft=True, use_symmetry=False)
TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def cnum(t):
    return t.detach().to(torch.complex128).numpy()


def held(port32, jax32, port64):
    """The fp32 result against the JAX package's complex64 one and the
    port's complex128 one, at TOL."""
    assert rel(cnum(port32), np.asarray(jax32, dtype=np.complex128)) <= TOL
    assert rel(cnum(port32), cnum(port64)) <= TOL


def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference",
        os.path.join(ROOT, "tools", "torch_port_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def reference():
    with open(os.path.join(ROOT, "sirius_tpu_torch", "data",
                           "jax_reference.json")) as f:
        return json.load(f)["decks"]


@pytest.fixture(scope="module")
def kset():
    """The small ultrasoft k-point deck with a random potential: the JAX
    package's complex64 and complex128 k-set params, and the port's built
    from their leaves."""
    jctx = jax_context(**SMALL, **US)
    rng = np.random.default_rng(41)
    veff = rng.uniform(-1.0, 0.5, tuple(jctx.fft_coarse.dims))
    jps32 = jax_hkset(jctx, veff, v0=0.3, dtype=jnp.complex64)
    jps64 = jax_hkset(jctx, veff, v0=0.3)
    leaves = {k: np.asarray(getattr(jps32, k)) for k in convert.HKSET_KEYS}
    leaves64 = {k: np.asarray(getattr(jps64, k)) for k in convert.HKSET_KEYS}
    assert leaves["ekin"].dtype == np.float32
    return dict(jctx=jctx, rng=rng, jps=jps32,
                ps=convert.hkset_from_numpy(leaves, "cpu", dtype=C64),
                ps64=convert.hkset_from_numpy(leaves64, "cpu"))


def block(rng, shape, mask=None):
    psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return psi if mask is None else psi * mask


def test_apply_h_s_fp32_matches_jax(kset):
    jctx, rng, jps = kset["jctx"], kset["rng"], kset["jps"]
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = block(rng, (nk, 6, ngk), np.asarray(jctx.gkvec.mask)[:, None, :])
    hk = kset["ps"].hk()
    assert hk.ekin.dtype == F32 and hk.beta.dtype == C64
    hp, sp = apply_h_s(hk, convert.psi_from_numpy(psi, "cpu", C64))
    assert hp.dtype == C64
    hp64, sp64 = apply_h_s(kset["ps64"].hk(), convert.psi_from_numpy(psi, "cpu"))
    for ik in range(nk):
        jh, js = jax_apply_h_s(hk_complex(hkset_slice_r(jps, ik, 0)),
                               jnp.asarray(psi[ik], dtype=jnp.complex64))
        held(hp[ik], jh, hp64[ik])
        held(sp[ik], js, sp64[ik])


def test_density_kset_fp32_matches_jax(kset):
    jctx, rng, jps = kset["jctx"], kset["rng"], kset["jps"]
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = block(rng, (nk, 1, 5, ngk), np.asarray(jctx.gkvec.mask)[:, None,
                                                                 None, :])
    psi32 = psi.astype(np.complex64)
    occ_w = rng.uniform(0.0, 0.3, (nk, 1, 5))
    want = np.asarray(jax_density_kset(jps, jnp.asarray(psi32.real),
                                       jnp.asarray(psi32.imag),
                                       jnp.asarray(occ_w)))
    got = density_kset(kset["ps"], convert.psi_from_numpy(psi, "cpu", C64),
                       torch.as_tensor(occ_w))
    assert got.dtype == F64
    got64 = density_kset(kset["ps64"], convert.psi_from_numpy(psi, "cpu"),
                         torch.as_tensor(occ_w))
    held(got, want, got64)


def test_mgga_fp32_matches_jax(kset):
    # the tau term of H (K11a, K1c, K11b) and tau itself (K11a, K3)
    jctx, rng, jps = kset["jctx"], kset["rng"], kset["jps"]
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    mask = np.asarray(jctx.gkvec.mask)
    psi = block(rng, (nk, 5, ngk), mask[:, None, :])
    vtau = rng.uniform(0.05, 0.4, tuple(jctx.fft_coarse.dims))
    gkc = np.asarray(jctx.gkvec.gkcart)
    vt, gk = convert.mgga_from_numpy(vtau, gkc, "cpu", F32)
    vt64, gk64 = convert.mgga_from_numpy(vtau, gkc, "cpu")
    hp, _ = apply_h_s_mgga(kset["ps"].hk(), vt, gk,
                           convert.psi_from_numpy(psi, "cpu", C64))
    hp64, _ = apply_h_s_mgga(kset["ps64"].hk(), vt64, gk64,
                             convert.psi_from_numpy(psi, "cpu"))
    for ik in range(nk):
        jh, _ = jax_mgga.apply_h_s_mgga(
            hk_complex(hkset_slice_r(jps, ik, 0)),
            jnp.asarray(vtau, dtype=jnp.float32),
            jnp.asarray(gkc[ik], dtype=jnp.float32),
            jnp.asarray(psi[ik], dtype=jnp.complex64))
        held(hp[ik], jh, hp64[ik])
    psi4 = psi[:, None].astype(np.complex64)
    occ_w = rng.uniform(0.0, 0.3, (nk, 1, 5))
    want = np.asarray(jax_mgga.tau_kset(
        jps.fft_index, jnp.asarray(gkc, dtype=jnp.float32),
        jnp.asarray(psi4.real), jnp.asarray(psi4.imag), jnp.asarray(occ_w),
        tuple(jctx.fft_coarse.dims)))
    got = tau_kset(kset["ps"], gk, convert.psi_from_numpy(psi4, "cpu", C64),
                   torch.as_tensor(occ_w))
    got64 = tau_kset(kset["ps64"], gk64, convert.psi_from_numpy(psi4, "cpu"),
                     torch.as_tensor(occ_w))
    held(got, want, got64)


@pytest.mark.parametrize("packed", [False, True], ids=["complex64",
                                                       "float32"])
def test_davidson_residual_step_fp32_matches_jax(packed):
    # one step of the JAX package's complex64 davidson body
    # (davidson.py:141-148 with _precondition) against K2's plain version,
    # on complex64 blocks and on float32 packed-real ones; the converged
    # branch is exercised by an exact eigenpair row
    rng = np.random.default_rng(43)
    b, nb, ngk = 2, 4, 40
    shape = (b, nb, ngk)
    real = np.float32 if packed else np.complex64

    def draw():
        x = rng.standard_normal(shape)
        if not packed:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(real)

    x, hx, sx = draw(), draw(), draw()
    hx[:, 0] = 2.0 * sx[:, 0]
    x[:, 0] = sx[:, 0]
    h_diag = rng.uniform(1.0, 3.0, (b, ngk)).astype(np.float32)
    o_diag = rng.uniform(0.9, 1.1, (b, ngk)).astype(np.float32)
    mask = (rng.uniform(size=(b, ngk)) > 0.2).astype(np.float32)
    tol = 1e-3

    def jax_step(x, hx, sx, hd, od, m):
        den = jnp.real(jnp.sum(x.conj() * sx, axis=1))
        ev = jnp.real(jnp.sum(x.conj() * hx, axis=1)) / jnp.where(
            jnp.abs(den) > 1e-30, den, 1.0)
        r = (hx - ev[:, None] * sx) * m
        rn = jnp.sqrt(jnp.real(jnp.sum(jnp.abs(r) ** 2, axis=1)))
        p = hd[None, :] - ev[:, None] * od[None, :]
        p = 0.5 * (1.0 + p + jnp.sqrt(1.0 + (p - 1.0) ** 2))
        w = jnp.where((rn < tol)[:, None], 0.0, r / p) * m
        return ev, rn, w

    got = k2.davidson_residual(*(torch.as_tensor(a) for a in (
        x, hx, sx, h_diag, o_diag, mask)), tol)
    assert got[0].dtype == F32 and got[2].dtype == torch.as_tensor(x).dtype
    assert bool((got[1][:, 0] < tol).all())
    got64 = k2.davidson_residual(*(torch.as_tensor(a).to(
        C128 if (a.dtype == np.complex64) else F64) for a in (
        x, hx, sx, h_diag, o_diag, mask)), tol)
    for i in range(b):
        want = jax_step(*(jnp.asarray(a[i]) for a in (x, hx, sx, h_diag,
                                                      o_diag, mask)))
        for g, w, g64 in zip(got, want, got64):
            held(g[i], w, g64[i])


@pytest.fixture(scope="module")
def gamma():
    spec = dict(SMALL, ngridk=(1, 1, 1), **US)
    jctx = jax_context(**spec)
    gm = jg.build_gamma_map(np.asarray(jctx.gkvec.millers[0]),
                            np.asarray(jctx.gkvec.mask[0]))
    rng = np.random.default_rng(45)
    veff = rng.uniform(-1.0, 0.5, tuple(jctx.fft_coarse.dims))
    return jctx, gm, rng, veff


def test_apply_h_s_gamma_fp32_matches_jax(gamma):
    jctx, gm, rng, veff = gamma
    jgp = jg.make_gamma_params(jctx, veff, gm, rdtype=jnp.float32)
    leaves = {k: np.asarray(getattr(jgp, k)) for k in convert.GAMMA_KEYS}
    assert leaves["beta_p"].dtype == np.float32
    gp = convert.gamma_params_from_numpy(leaves, "cpu", F32)
    gp64 = tg.make_gamma_params(port_context(**dict(SMALL, ngridk=(1, 1, 1),
                                                    **US)),
                                veff, gm, device="cpu")
    assert gp.beta_p.dtype == F32 and gp.fft_index.dtype == torch.int32
    x = rng.standard_normal((1, 6, jctx.gkvec.ngk_max))
    hx, sx = tg.apply_h_s_gamma(gp, convert.packed_from_numpy(x, "cpu", F32))
    assert hx.dtype == F32
    hx64, sx64 = tg.apply_h_s_gamma(gp64, convert.packed_from_numpy(x, "cpu"))
    jh, js = jg.apply_h_s_gamma(jgp, jnp.asarray(x[0], dtype=jnp.float32))
    held(hx[0], jh, hx64[0])
    held(sx[0], js, sx64[0])
    # the fp64 unpack of the float32 bands is the JAX package's host unpack
    xg = hx.double()[0]
    np.testing.assert_array_equal(tg.unpack_device(gp64, xg).numpy(),
                                  tg.unpack(gm, xg.numpy()))


def test_apply_h_s_chunked_fp32_matches_jax(gamma):
    jctx, _, rng, veff = gamma
    d = np.array(jctx.beta.dion, dtype=np.float64)
    prm = jb.make_chunked_hk(jctx, 0, dtype=jnp.complex64, chunk=1)
    prm = dict(prm, veff_r=jnp.asarray(veff, dtype=jnp.float32),
               dmat=jnp.asarray(jb.pack_dmat_chunks(jctx, d, 1),
                                dtype=jnp.float32))
    leaves = {k: np.asarray(v) for k, v in prm.items()}
    assert leaves["ri_grid"].dtype == np.float32
    port = convert.chunked_params_from_numpy(leaves, "cpu", C64)
    assert port.cph.dtype == C64 and port.q.dtype == F32
    psi = block(rng, (1, 5, jctx.gkvec.ngk_max),
                np.asarray(jctx.gkvec.mask)[:1, None, :])
    h, s = tb.apply_h_s_chunked(port, convert.psi_from_numpy(psi, "cpu", C64))
    jh, js = jb.apply_h_s_chunked(prm, jnp.asarray(psi[0],
                                                   dtype=jnp.complex64))
    # the fp64 twin: the JAX package's fp64 tables
    prm64 = dict(jb.make_chunked_hk(jctx, 0, chunk=1),
                 veff_r=jnp.asarray(veff),
                 dmat=jnp.asarray(jb.pack_dmat_chunks(jctx, d, 1)))
    port64 = convert.chunked_params_from_numpy(
        {k: np.asarray(v) for k, v in prm64.items()}, "cpu")
    h64, s64 = tb.apply_h_s_chunked(port64, convert.psi_from_numpy(psi, "cpu"))
    assert h.dtype == C64
    held(h[0], jh, h64[0])
    held(s[0], js, s64[0])


@pytest.fixture(scope="module")
def spinor():
    spec = dict(gk_cutoff=3.5, pw_cutoff=9.0, ngridk=(2, 2, 2), num_bands=16,
                ultrasoft=True, use_symmetry=True,
                moments=np.asarray([[0.3, 0.3, 0.3]] * 2),
                extra_params={"num_mag_dims": 3})
    jctx, pctx = jax_context(**spec), port_context(**spec)
    rng = np.random.default_rng(47)
    dims = tuple(jctx.fft_coarse.dims)
    nbeta = jctx.beta.num_beta_total
    boxes = np.stack([rng.uniform(-1.0, 0.5, dims) for _ in range(4)])
    boxes[2:] *= 0.3
    dmat = 0.4 * (rng.standard_normal((4, nbeta, nbeta))
                  + 1j * rng.standard_normal((4, nbeta, nbeta)))
    qmat = 0.05 * (rng.standard_normal((4, nbeta, nbeta))
                   + 1j * rng.standard_normal((4, nbeta, nbeta)))
    return jctx, pctx, rng, boxes, dmat, qmat


def test_apply_h_s_nc_fp32_matches_jax(spinor):
    jctx, pctx, rng, boxes, dmat, qmat = spinor
    nk, ngk = jctx.gkvec.num_kpoints, jctx.gkvec.ngk_max
    psi = block(rng, (nk, 6, 2 * ngk))
    ps = tbnc.make_nc_set_params(pctx, boxes, dmat, qmat, device="cpu",
                                 dtype=C64)
    ps64 = tbnc.make_nc_set_params(pctx, boxes, dmat, qmat, device="cpu")
    assert ps.veff.dtype == F32 and ps.dmat.dtype == C64
    h, s = tspinor.apply_h_s_nc(ps, torch.as_tensor(psi).to(C64))
    h64, s64 = tspinor.apply_h_s_nc(ps64, torch.as_tensor(psi))
    f32 = dict(dtype=jnp.float32)
    c64 = dict(dtype=jnp.complex64)
    for ik in range(nk):
        prm = jspinor.NcHkParams(
            *(jnp.asarray(b, **f32) for b in boxes),
            ekin=jnp.asarray(jctx.gkvec.kinetic()[ik], **f32),
            mask=jnp.asarray(jctx.gkvec.mask[ik], **f32),
            fft_index=jnp.asarray(jctx.gkvec.fft_index[ik]),
            beta=jnp.asarray(jctx.beta.beta_gk[ik], **c64),
            dmat=jnp.asarray(dmat, **c64), qmat=jnp.asarray(qmat, **c64))
        jh, js = jspinor.apply_h_s_nc(prm, jnp.asarray(psi[ik], **c64))
        held(h[ik], jh, h64[ik])
        held(s[ik], js, s64[ik])


def test_density_kset_nc_fp32_matches_jax(spinor):
    jctx, pctx, rng, boxes, dmat, _ = spinor
    nk, nb, ngk = jctx.gkvec.num_kpoints, 16, jctx.gkvec.ngk_max
    # masked: the JAX package's scatter adds the padded lanes into G = 0
    mask2 = np.tile(np.asarray(jctx.gkvec.mask), (1, 2))[:, None, :]
    psi = block(rng, (nk, nb, 2 * ngk), mask2).astype(np.complex64)
    occ_w = rng.uniform(0.0, 0.3, (nk, nb))
    jps = jbnc.make_nc_set_params(jctx, tuple(boxes), dmat,
                                  dtype=jnp.complex64)
    leaves = {k: np.asarray(getattr(jps, k)) for k in convert.NC_SET_KEYS}
    ps = convert.nc_set_from_numpy(leaves, "cpu", C64)
    assert ps.h_diag.dtype == F32
    want = np.asarray(jbnc.density_kset_nc(jps, jnp.asarray(psi.real),
                                           jnp.asarray(psi.imag),
                                           jnp.asarray(occ_w)))
    got = tbnc.density_kset_nc(ps, torch.as_tensor(psi),
                               torch.as_tensor(occ_w))
    got64 = tbnc.density_kset_nc(
        tbnc.make_nc_set_params(pctx, boxes, dmat, device="cpu"),
        torch.as_tensor(psi).to(C128), torch.as_tensor(occ_w))
    assert got.dtype == F64
    held(got, want, got64)
    # the fp32 set's h_diag: the fp64 one cast, as the JAX package casts it
    np.testing.assert_array_equal(
        tbnc.make_nc_set_params(pctx, boxes, dmat, device="cpu",
                                dtype=C64).h_diag.numpy(), leaves["h_diag"])


def test_entry_points_match_their_signatures():
    # every C entry point of csrc/ has its ctypes signature, with as many
    # arguments: the fp32 instantiations' names and the fp64 ones'
    for name in build.SOURCES:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', f.read())
        got = {fn: len([a for a in args.split(",") if a.strip()])
               for fn, args in decls}
        assert set(got) == set(build.SIGNATURES[name]), name
        for fn, n in got.items():
            assert n == len(build.SIGNATURES[name][fn]), fn
    for stem in ("pw_to_box", "box_to_pw", "veff_multiply",
                 "veff_multiply_real", "davidson_residual",
                 "density_accumulate", "density_accumulate_nc",
                 "beta_chunk", "grad_to_box", "box_to_pw_tau", "spinor_veff"):
        assert any(stem + "_c64" in sig for sig in build.SIGNATURES.values())
    for stem in ("unpack_to_box", "box_to_packed_hx", "davidson_residual"):
        assert any(stem + "_f32" in sig for sig in build.SIGNATURES.values())


def _mixed_calls():
    """Each fp32 wrapper with one table of the other precision."""
    b, r, ngk, n = 1, 2, 8, 16
    c = torch.zeros((b, r, ngk), dtype=C64)
    idx = torch.zeros((b, ngk), dtype=torch.int32)
    m64 = torch.ones((b, ngk), dtype=F64)
    box = torch.zeros((b, r, n), dtype=C64)
    gkc = torch.zeros((b, ngk, 3), dtype=F64)
    return {
        "pw_to_box": lambda: k1.pw_to_box(c, idx, m64, n),
        "box_to_pw_hpsi": lambda: k1.box_to_pw_hpsi(box, c, m64, m64, idx),
        "veff_multiply": lambda: k1c.veff_multiply(box, torch.ones((1, n),
                                                                   dtype=F64)),
        "davidson_residual": lambda: k2.davidson_residual(
            c, c, c, m64, m64, m64, 1e-6),
        "density_accumulate": lambda: k3.density_accumulate(
            torch.zeros((1, n), dtype=F64), box, torch.ones((1, r),
                                                            dtype=F32), 1.0),
        "grad_to_box": lambda: k11.grad_to_box(c, gkc, 0, idx,
                                               m64.to(F32), n),
        "spinor_veff": lambda: k12a.spinor_veff(
            torch.zeros((2, 2, n), dtype=C64),
            *(torch.ones(n, dtype=F64) for _ in range(4))),
        "unpack_to_box": lambda: k8.unpack_to_box(
            torch.zeros((b, r, ngk), dtype=F32), torch.ones(ngk, dtype=F64),
            idx[0], idx[0], torch.ones(ngk, dtype=F32),
            torch.ones(ngk, dtype=F32), idx[0], n),
        "beta_chunk": lambda: k9.beta_chunk(
            torch.zeros((1, 3), dtype=F32), torch.zeros((1, 1),
                                                        dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=C128), torch.zeros((ngk, 1), dtype=F32),
            torch.zeros(ngk, dtype=F32), torch.zeros((ngk, 3), dtype=F32),
            torch.zeros((1, 4), dtype=F32), 0.1, 1.0),
    }


@pytest.mark.parametrize("kernel", sorted(_mixed_calls()))
def test_fp32_wrappers_refuse_mixed_types(kernel):
    # a complex64 block with a float64 table (or the reverse) is no
    # instantiation: the wrapper raises rather than cast either operand
    with pytest.raises(ValueError):
        _mixed_calls()[kernel]()


def test_precision_wf_values():
    # "fp32" runs; any other string raises ValueError, as in the JAX
    # package (scf.py:264-265)
    ctx = port_context(**dict(SMALL, ngridk=(1, 1, 1), **US),
                       extra_params={"num_dft_iter": 1})
    ctx.cfg.parameters.precision_wf = "fp16"
    with pytest.raises(ValueError, match="fp32 or fp64"):
        run_scf(ctx.cfg, ctx=ctx, device="cpu")


def precision_run(name):
    """run_scf on a deck of the reference tool (the precision decks and the
    small ones), on the CPU."""
    shape, kind, control, params, moments = reference_tool().deck_spec(name)
    ctx = port_context(extra_params=dict(params), **kind, **shape,
                       moments=None if moments is None else np.asarray(moments))
    reference_tool().apply_control(ctx.cfg, control)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    res["electrons"] = (float(res["_state"]["rho_g"][0].real)
                        * ctx.unit_cell.omega)
    return res


def test_pure_fp32_lands_near_fp64(reference):
    # tests/test_precision.py's fp32 case: converged to fp32 tolerances
    res = precision_run("precision_us_fp32")
    want = reference["precision_us"]["energy"]["total"]
    assert res["converged"]
    assert set(res["wf_precision"]) == {"fp32"}
    assert abs(res["energy"]["total"] - want) <= 5e-5


def test_fp32_polish_recovers_fp64(reference):
    # the fp32 -> fp64 switch fires once the density residual is below
    # 1e-4 and at least one fp64 iteration follows; every term then lands
    # on the fp64 record. Converged to 1e-11, the stop moves by a few
    # iterations with the rounding of the threaded CPU sums (measured: 18,
    # 17, 21 iterations with 1, 2, 4 torch threads, the JAX package 18), so
    # the count is taken on one thread, the tests' own setting under xdist
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = precision_run("precision_us_fp32_polish")
    finally:
        torch.set_num_threads(threads)
    rec = reference["precision_us_fp32_polish"]
    twin = reference[rec["twin"]]
    prec = res["wf_precision"]
    k = prec.index("fp64")
    assert k >= 1 and set(prec[:k]) == {"fp32"} and set(prec[k:]) == {"fp64"}
    assert res["rms_history"][k - 1] < 1e-4 <= min(res["rms_history"][:k - 1]
                                                    or [1.0])
    assert res["converged"] and len(prec) > k
    assert abs(res["num_scf_iterations"] - rec["num_scf_iterations"]) <= 1
    for key, want in twin["energy"].items():
        assert abs(res["energy"][key] - want) <= 1e-8, key
    assert abs(res["electrons"] - twin["electrons"]) <= 1e-8


def test_fixed_count_fp32_within_the_jax_gap(reference):
    # every term and the electron count within 4x the JAX package's own
    # largest fp32-vs-fp64 gap over its three fp32 runs of the deck, the
    # terms at most 1e-4 Ha
    res = precision_run("precision_us_fp32_fixed10")
    rec = reference["precision_us_fp32_fixed10"]
    twin = reference[rec["twin"]]
    assert rec["twin_runs"] == 3
    limit = min(4.0 * rec["twin_max_gap"], 1e-4)
    assert res["num_scf_iterations"] == 10
    for key, want in twin["energy"].items():
        assert abs(res["energy"][key] - want) <= limit, key
    assert abs(res["electrons"] - twin["electrons"]) <= (
        4.0 * rec["twin_electron_gap"])


PATHS = {
    "kset": (SMALL, dict(ultrasoft=True, use_symmetry=True), {}, {}),
    "gamma": (dict(SMALL, ngridk=(1, 1, 1)), US, {}, {}),
    "chunked": (dict(SMALL, ngridk=(1, 1, 1)), US,
                {"beta_chunked": True, "beta_chunk_size": 1}, {}),
    "scan": (SMALL, dict(ultrasoft=True, use_symmetry=True), {},
             {"xc_functionals": ["XC_MGGA_X_SCAN", "XC_MGGA_C_SCAN"]}),
    "kset_nc": (dict(gk_cutoff=3.5, pw_cutoff=9.0, ngridk=(1, 1, 1),
                     num_bands=16), US, {}, {"num_mag_dims": 3}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_band_solve_path_runs_fp32(path, monkeypatch):
    # two fp32 iterations on each path: every residual step of the band
    # solve sees complex64 (or float32 packed) blocks, the energies are
    # finite, and the result reports the precision
    shape, kind, control, extra = PATHS[path]
    moments = (np.asarray([[0.5, 0, 0], [0, 0, 0.5]])
               if path == "kset_nc" else None)
    ctx = port_context(**shape, **kind, moments=moments,
                       extra_params={"num_dft_iter": 2, "precision_wf": "fp32",
                                     **extra})
    for key, value in control.items():
        setattr(ctx.cfg.control, key, value)
    want = {"scan": "kset"}.get(path, path)
    assert band_solve_path(ctx.cfg, ctx) == want
    seen = set()
    inner = tdav.davidson_residual

    def spy(x, *args, **kw):
        seen.add(x.dtype)
        return inner(x, *args, **kw)

    monkeypatch.setattr(tdav, "davidson_residual", spy)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    assert seen == ({F32} if path == "gamma" else {C64})
    assert res["wf_precision"] == ["fp32", "fp32"]
    assert res["num_scf_iterations"] == 2
    assert all(np.isfinite(v) for v in res["energy"].values())


def test_polish_switches_the_band_solve_to_fp64(monkeypatch):
    # with the switch set above the first residual, the second iteration's
    # band solve runs on complex128 blocks (the k-set tables rebuilt at
    # fp64) and that iteration may not end the run
    ctx = port_context(**SMALL, ultrasoft=True, use_symmetry=True,
                       extra_params={"num_dft_iter": 3,
                                     "precision_wf": "fp32",
                                     "density_tol": 1.0, "energy_tol": 1.0})
    ctx.cfg.settings.fp32_to_fp64_rms = 1.0
    seen = []
    inner = tdav.davidson_residual

    def spy(x, *args, **kw):
        seen.append(x.dtype)
        return inner(x, *args, **kw)

    monkeypatch.setattr(tdav, "davidson_residual", spy)
    res = run_scf(ctx.cfg, ctx=ctx, device="cpu")
    # iteration 1 switches, iteration 2 is the forced fp64 one, and with
    # loose tolerances iteration 2 converges
    assert res["wf_precision"] == ["fp32", "fp64"]
    assert res["converged"] and res["num_scf_iterations"] == 2
    assert seen[0] == C64 and seen[-1] == C128
    assert res["_state"]["psi"].dtype == C128
