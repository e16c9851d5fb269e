"""Build and load the hand-written CUDA kernels of the port.

Each source under ``sirius_tpu_torch/csrc/`` is compiled by its own ``nvcc``
into a shared library with a plain C interface, loaded with ``ctypes``. The
libraries go into ``sirius_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing is built at import: the first
launch on a CUDA tensor builds its library, and ``build_all`` builds every
library at once with the compilers running in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("local_hpsi", "davidson_residual", "density_accumulate", "lda_xc",
           "veff_multiply", "augmentation", "symmetrize_pw", "gamma_pack",
           "beta_chunk", "gga_xc", "xc_gradient", "mgga_xc", "mgga_tau",
           "spinor_veff", "fermi", "mixer", "scf_record", "eigh_jacobi",
           "density_scatter", "h_diag", "potential_passes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the libraries a source links, found at run time in the toolkit beside nvcc
LINK = {"eigh_jacobi": ("-lcusolver",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
# argtypes of every exported function: pointers and the stream as void*,
# so ctypes never truncates a pointer to a 32-bit int
# (the fp32 instantiations, suffixed _c64 for complex64 blocks and _f32 for
# float32 packed-real blocks, take the same arguments as their fp64 twins)
_K1_SCATTER = (_P, _P, _P, _P, _I, _I, _I, _LL, _I, _P)
_K1_GATHER = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _P)
_K1C = (_P, _P, _I, _I, _I, _LL, _P)
_K2 = (_P, _P, _P, _P, _P, _P, _D, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_K3 = (_P, _P, _P, _I, _I, _LL, _D, _P)
_K12B = (_P, _P, _P, _I, _LL, _D, _P)
_K8A = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _P)
_K8B = (_P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _I, _I, _LL, _P)
_K9 = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D,
       _D, _P)
_K11 = (_P, _P, _I, _P, _P, _P, _I, _I, _I, _LL, _I, _P)
_K12A = (_P, _P, _P, _P, _P, _LL, _LL, _P)
_K6 = (_P, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P)
SIGNATURES = {
    "local_hpsi": {
        "pw_to_box": _K1_SCATTER, "pw_to_box_c64": _K1_SCATTER,
        "box_to_pw": _K1_GATHER, "box_to_pw_c64": _K1_GATHER,
    },
    "davidson_residual": {
        "davidson_residual": _K2, "davidson_residual_f64": _K2,
        "davidson_residual_c64": _K2, "davidson_residual_f32": _K2,
    },
    "density_accumulate": {
        "density_accumulate": _K3, "density_accumulate_c64": _K3,
        "density_accumulate_nc": _K12B, "density_accumulate_nc_c64": _K12B,
    },
    "lda_xc": {
        "lda_xc": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
    },
    "veff_multiply": {
        "veff_multiply": _K1C, "veff_multiply_real": _K1C,
        "veff_multiply_c64": _K1C, "veff_multiply_real_c64": _K1C,
    },
    "augmentation": {
        "rho_aug": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _LL,
                    _LL, _I, _I, _I, _I, _P),
        "rho_aug_phase_check": (_P, _P, _P, _LL, _I, _P, _P),
        "d_operator": (_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _D, _P,
                       _I, _I, _I, _LL, _LL, _P),
    },
    "symmetrize_pw": {
        "symmetrize_pw": _K6,
        "symmetrize_vector_pw": _K6,
    },
    "gamma_pack": {
        "unpack_to_box": _K8A, "unpack_to_box_f32": _K8A,
        "box_to_packed_hx": _K8B, "box_to_packed_hx_f32": _K8B,
    },
    "beta_chunk": {"beta_chunk": _K9, "beta_chunk_c64": _K9},
    "gga_xc": {
        "gga_xc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
    },
    "xc_gradient": {
        "gradient_boxes": (_P, _P, _P, _P, _I, _I, _LL, _P),
        "divergence_pw": (_P, _P, _P, _P, _I, _I, _LL, _P),
    },
    "mgga_xc": {
        "mgga_xc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                    _I, _I, _I, _P),
    },
    "mgga_tau": {
        "grad_to_box": _K11, "grad_to_box_c64": _K11,
        "box_to_pw_tau": _K11, "box_to_pw_tau_c64": _K11,
    },
    "spinor_veff": {"spinor_veff": _K12A, "spinor_veff_c64": _K12A},
    "fermi": {"fermi_level": (_P, _P, _I, _I, _D, _D, _D, _I, _I, _P, _P,
                              _P)},
    "mixer": {
        "mixer_gram": (_P, _P, _P, _P, _P, _I, _I, _I, _LL, _P, _P, _P),
        "mixer_update": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _D,
                         _P, _P, _P, _P, _P, _P, _P),
    },
    "scf_record": {"scf_record": (_P, _P, _P, _I, _I, _P, _P, _P)},
    "density_scatter": {
        "coarse_box": (_P, _D, _LL, _P, _P),
        "scatter_fine": (_P, _P, _I, _LL, _LL, _P, _P),
    },
    "h_diag": {"h_diag": (_P, _P, _P, _P, _I, _I, _LL, _P, _P)},
    "potential_passes": {
        "hartree_veff": (_P, _P, _P, _P, _D, _D, _D, _LL, _P, _P, _P),
        "gga_inputs": (_P, _P, _P, _D, _D, _D, _LL, _P, _P),
        "xc_inputs": (_P, _P, _P, _D, _LL, _P, _P, _P, _P, _P, _P, _P),
        "xc_outputs": (_P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P),
        "coarse_fill": (_P, _P, _P, _P, _I, _P, _LL, _P, _P, _P, _P, _P),
        "coarse_stack": (_P, _P, _P, _P, _I, _I, _LL, _P, _P),
    },
    "eigh_jacobi": {
        "eigh_jacobi_f32": (_P, _P, _I, _I, _P, _P),
        "eigh_jacobi_f64": (_P, _P, _I, _I, _P, _P),
        "eigh_jacobi_c64": (_P, _P, _I, _I, _P, _P),
        "eigh_jacobi_c128": (_P, _P, _I, _I, _P, _P),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    flags = NVCC_FLAGS + LINK.get(name, ())
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the libraries it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if name in LINK:
            lib64 = os.path.join(os.path.dirname(os.path.dirname(nvcc)),
                                 "lib64")
            cmd += [*LINK[name], "-Xlinker", f"-rpath,{lib64}"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    times = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: {log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def variant(dtype) -> tuple:
    """(real dtype of the tables, suffix) of a kernel instantiation, by the
    element type of the block it takes: complex128 and float64 blocks run
    the fp64 instantiation (no suffix), complex64 blocks the "_c64" one and
    float32 packed-real blocks the "_f32" one, each with its C entry point
    and launch counter ("launches" + suffix) named by the suffix. Raises
    for any other type: no block is cast to reach a kernel."""
    import torch

    table = {torch.complex128: (torch.float64, ""),
             torch.float64: (torch.float64, ""),
             torch.complex64: (torch.float32, "_c64"),
             torch.float32: (torch.float32, "_f32")}
    if dtype not in table:
        raise ValueError(f"no kernel instantiation for {dtype}")
    return table[dtype]


def count_launch(fn, suffix: str) -> None:
    """Add one to the launch counter of an instantiation of a wrapper."""
    name = "launches" + suffix
    setattr(fn, name, getattr(fn, name) + 1)


def on_cuda(t, what: str) -> bool:
    """True for a CUDA tensor (its kernel launches), False for a CPU one
    (its plain version runs); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check_fields(what: str, dtype, ref, *fields, shape=None,
                 flat: bool = False) -> None:
    """Every (name, tensor) of fields (None skipped) of dtype, of ref's
    shape (or shape; flat: of its number of elements) and on ref's device,
    and a complex128 one on the card at a 16-byte boundary (the kernels
    load whole complex values); raises ValueError otherwise."""
    import math

    import torch

    want = tuple(ref.shape) if shape is None else tuple(shape)
    for name, t in fields:
        if t is None:
            continue
        fits = (t.numel() == math.prod(want) if flat
                else tuple(t.shape) == want)
        if t.dtype != dtype or not fits or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be {dtype} "
                             f"{'of ' if flat else ''}{want} on "
                             f"{ref.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if (t.dtype == torch.complex128 and t.device.type == "cuda"
                and t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} is off a 16-byte boundary")


def ptr(t):
    """A tensor's device pointer for a C entry, None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (the launch plans size their
    grids by it)."""
    import torch

    device = torch.device(device)
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def stream_of(t) -> int:
    """The raw cudaStream_t of the current stream on a tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
