"""HDF5 checkpoint/restart (reference: sirius.h5 state file —
Density::save/load, Potential::save/load writing PW coefficient arrays,
density.hpp:603-630; task ground_state_restart reloads rho/V and re-runs
SCF, sirius.scf.cpp:147-155).

Layout (schema version 2):
  /meta: miller indices + lattice (to validate compatibility on load),
         schema version + sha256 content checksum attrs
  /density/rho_g, /density/mag_g (optional)
  /potential/veff_g, /potential/bz_g (optional)
  /kset/psi, /kset/band_energies, /kset/band_occupancies (optional)
  /scf: mid-SCF resume state (optional; run_scf control.autosave_every):
        packed mixed vector, mixer history, residual tolerance, iteration
        counter and convergence histories — enough to restart an SCF run
        mid-loop bit-reproducibly on the host path.
  /md:  molecular-dynamics restart state (optional; md/driver.py
        md.autosave_every): step counter, positions/velocities/forces,
        thermostat work, conserved-quantity history and the
        density/wave-function extrapolation histories — enough to resume a
        trajectory that replays identically to the uninterrupted run
        (thermostat noise is counter-based, so no RNG state is stored).

Writes are preemption-safe: the file is written to a same-directory temp
path and atomically os.replace()d over the target, so a kill mid-save never
leaves a corrupt or half-written checkpoint — the previous snapshot stays
loadable. Loads verify a sha256 over every dataset and raise
CheckpointError naming the field that failed validation.

Device-agnostic contract: every array that enters a checkpoint is a host
numpy array (a tensor on the card is copied to the host first), and
nothing about the device or the mesh is part of the layout. Validity is
keyed on the *physics* (G-set Miller indices + lattice), so an /scf
autosave written on one device (or by the JAX package on any mesh)
resumes on any other. Do not add device-topology-dependent fields to the
schema without a resharding path.

A copy of sirius_tpu/io/checkpoint.py over io/h5.py, the port's own
reader and writer of the HDF5 subset the schema uses (the HDF5 library's
Python binding is not installed on every machine the port runs on): the
same layout, attribute types, validation messages and sha256 digest, so a
file written by either package loads in the other, checksum included.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from sirius_tpu_torch.io import h5
from sirius_tpu_torch.utils import faults

# bump when the layout changes incompatibly; absence of the attr means a
# pre-versioning (v1) file, which is still loadable
SCHEMA_VERSION = 2


class CheckpointError(ValueError):
    """Checkpoint missing, corrupt, or incompatible with the current
    context. Subclasses ValueError so pre-existing callers that caught the
    old bare ValueError keep working."""


def _content_digest(f) -> str:
    """sha256 over every dataset (name, shape, dtype, bytes) in the file,
    walked in sorted order so the digest is layout-deterministic. While a
    file is written it hashes the arrays as they will be stored."""
    h = hashlib.sha256()
    names: list[str] = []
    f.visit(lambda n: names.append(n))
    for name in sorted(names):
        obj = f[name]
        if not isinstance(obj, h5.Dataset):
            continue
        a = np.ascontiguousarray(obj[...])
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def save_state(
    path: str,
    ctx,
    rho_g: np.ndarray,
    mag_g: np.ndarray | None = None,
    veff_g: np.ndarray | None = None,
    bz_g: np.ndarray | None = None,
    psi: np.ndarray | None = None,
    band_energies: np.ndarray | None = None,
    band_occupancies: np.ndarray | None = None,
    paw_dm: np.ndarray | None = None,
    scf_state: dict | None = None,
    md_state: dict | None = None,
    rotate_keep: int = 0,
) -> None:
    """scf_state: optional mid-SCF resume payload (run_scf autosave):
    scalar entries become /scf attrs, array entries /scf datasets.
    md_state: optional MD trajectory restart payload (md/driver.py),
    encoded the same way under /md.

    rotate_keep: keep the last N snapshots by shifting path -> path.1 ->
    ... -> path.(N-1) (logrotate style) before the atomic rename; 0 keeps
    the historical single-file overwrite."""

    # atomic write: temp file in the SAME directory (os.replace must not
    # cross filesystems), fsync'd, then renamed over the target. A kill at
    # any point leaves either the old snapshot or the new one — never a
    # truncated file (reference robustness requirement for restartable
    # ground states; preemption-safety for long jobs).
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with h5.File(tmp, "w") as f:
            meta = f.create_group("meta")
            meta.create_dataset("millers", data=ctx.gvec.millers)
            meta.create_dataset("lattice", data=ctx.unit_cell.lattice)
            meta.attrs["num_gvec"] = ctx.gvec.num_gvec
            meta.attrs["pw_cutoff"] = float(ctx.cfg.parameters.pw_cutoff)
            meta.attrs["gk_cutoff"] = float(ctx.cfg.parameters.gk_cutoff)
            meta.attrs["version"] = SCHEMA_VERSION
            # per-k G+k sphere indices: lets load_state remap wave functions
            # onto a slightly different G-set (restart across small lattice
            # changes — variable-cell relaxation, stress FD seeding)
            meta.create_dataset("gk_millers", data=ctx.gkvec.millers)
            meta.create_dataset("num_gk", data=np.asarray(ctx.gkvec.num_gk))
            meta.create_dataset("kpoints", data=np.asarray(ctx.gkvec.kpoints))
            den = f.create_group("density")
            den.create_dataset("rho_g", data=np.asarray(rho_g))
            if mag_g is not None:
                den.create_dataset("mag_g", data=np.asarray(mag_g))
            if paw_dm is not None:
                den.create_dataset("paw_dm", data=np.asarray(paw_dm))
            if veff_g is not None:
                pot = f.create_group("potential")
                pot.create_dataset("veff_g", data=np.asarray(veff_g))
                if bz_g is not None:
                    pot.create_dataset("bz_g", data=np.asarray(bz_g))
            if psi is not None:
                ks = f.create_group("kset")
                ks.create_dataset("psi", data=np.asarray(psi))
                if band_energies is not None:
                    ks.create_dataset(
                        "band_energies", data=np.asarray(band_energies)
                    )
                if band_occupancies is not None:
                    ks.create_dataset(
                        "band_occupancies", data=np.asarray(band_occupancies)
                    )
            for gname, payload in (("scf", scf_state), ("md", md_state)):
                if payload is None:
                    continue
                sg = f.create_group(gname)
                for k, v in payload.items():
                    if v is None:
                        continue
                    a = np.asarray(v)
                    if a.ndim == 0:
                        # numpy unicode scalars (e.g. the mixer kind) have
                        # no native HDF5 type; store as plain python str so
                        # it is written as a variable-length utf-8 attr
                        sg.attrs[k] = (str(a[()]) if a.dtype.kind == "U"
                                       else a[()])
                    else:
                        sg.create_dataset(k, data=a)
            meta.attrs["sha256"] = _content_digest(f)
        # simulate preemption between the durable temp write and the
        # rename: the previous snapshot at `path` must remain loadable
        faults.check("checkpoint.before_rename")
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if rotate_keep > 0 and os.path.exists(path):
            # shift the existing generations up; each step is itself an
            # atomic rename, so a kill mid-rotation loses at most the
            # oldest generation, never the newest
            if os.path.exists(f"{path}.{rotate_keep - 1}"):
                try:
                    os.remove(f"{path}.{rotate_keep - 1}")
                except OSError:
                    pass
            for i in range(rotate_keep - 1, 1, -1):
                if os.path.exists(f"{path}.{i - 1}"):
                    os.replace(f"{path}.{i - 1}", f"{path}.{i}")
            if rotate_keep > 1:
                os.replace(path, f"{path}.1")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load_state(path: str, ctx, verify_checksum: bool = True) -> dict:
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint file does not exist: {path}")
    out: dict = {}
    try:
        f = h5.File(path, "r")
    except OSError as e:
        raise CheckpointError(
            f"checkpoint unreadable (truncated or not HDF5): {path}: {e}"
        ) from e
    with f:
        if "meta" not in f:
            raise CheckpointError(
                "checkpoint validation failed on field 'meta': group missing "
                f"in {path}"
            )
        version = int(f["meta"].attrs.get("version", 1))
        if version > SCHEMA_VERSION:
            raise CheckpointError(
                "checkpoint validation failed on field 'version': file has "
                f"schema v{version}, this build reads up to "
                f"v{SCHEMA_VERSION}"
            )
        if verify_checksum and "sha256" in f["meta"].attrs:
            want = str(f["meta"].attrs["sha256"])
            got = _content_digest(f)
            if got != want:
                raise CheckpointError(
                    "checkpoint validation failed on field 'sha256': "
                    f"content digest {got[:12]}… != recorded {want[:12]}… "
                    "(file corrupt or modified)"
                )
        if "millers" not in f["meta"] or "lattice" not in f["meta"]:
            missing = "millers" if "millers" not in f["meta"] else "lattice"
            raise CheckpointError(
                f"checkpoint validation failed on field '{missing}': dataset "
                "missing from /meta"
            )
        mill = f["meta/millers"][...]
        exact = mill.shape == ctx.gvec.millers.shape and np.array_equal(
            mill, ctx.gvec.millers
        )
        lat_ok = np.allclose(
            f["meta/lattice"][...], ctx.unit_cell.lattice, atol=1e-10
        )
        g_map = None
        gk_maps = None
        if exact and not lat_ok:
            # same G enumeration under a small lattice change (hydrostatic
            # strain preserves the ordering): accept as-is, no remap needed
            lat_scale = float(np.abs(ctx.unit_cell.lattice).max())
            if (
                np.abs(f["meta/lattice"][...] - ctx.unit_cell.lattice).max()
                > 0.05 * lat_scale
            ):
                raise CheckpointError(
                    "checkpoint validation failed on field 'lattice': saved "
                    "lattice differs from the current cell by more than 5%"
                )
        elif not exact:
            # remap by Miller index: restart across a small lattice change
            # (variable-cell relaxation step, strained-lattice seeding);
            # G vectors leaving the sphere are dropped, entering ones -> 0.
            # Requires the SAME cutoffs — a different G-set by cutoff is a
            # user error and still refuses.
            lat_saved = f["meta/lattice"][...]
            lat_scale = float(np.abs(ctx.unit_cell.lattice).max())
            cut_ok = (
                "pw_cutoff" in f["meta"].attrs
                and float(f["meta"].attrs["pw_cutoff"])
                == float(ctx.cfg.parameters.pw_cutoff)
                and float(f["meta"].attrs["gk_cutoff"])
                == float(ctx.cfg.parameters.gk_cutoff)
            )
            if not cut_ok:
                raise CheckpointError(
                    "checkpoint validation failed on field 'millers': saved "
                    "G set was built with different pw_cutoff/gk_cutoff than "
                    "the current context"
                )
            if (
                np.abs(lat_saved - ctx.unit_cell.lattice).max()
                > 0.05 * lat_scale
            ):
                raise CheckpointError(
                    "checkpoint validation failed on field 'lattice': saved "
                    "G set cannot be remapped across a lattice change "
                    "larger than 5%"
                )
            saved = {tuple(m): i for i, m in enumerate(mill)}
            g_map = np.array(
                [saved.get(tuple(m), -1) for m in ctx.gvec.millers],
                dtype=np.int64,
            )
            # psi remap needs the SAME k-point list (index-paired): a
            # changed IBZ (symmetry broken by the strain) silently drops
            # psi from the restart rather than scattering coefficients
            # onto wrong k spheres
            k_same = (
                "kpoints" in f["meta"]
                and f["meta/kpoints"].shape == ctx.gkvec.kpoints.shape
                and np.allclose(
                    f["meta/kpoints"][...], ctx.gkvec.kpoints, atol=1e-10
                )
            )
            if "gk_millers" in f["meta"] and k_same:
                gk_mill = f["meta/gk_millers"][...]
                gk_num = f["meta/num_gk"][...]
                gk_maps = []
                for ik in range(ctx.gkvec.num_kpoints):
                    sk = {
                        tuple(m): i
                        for i, m in enumerate(gk_mill[ik][: int(gk_num[ik])])
                    }
                    nk_now = int(ctx.gkvec.num_gk[ik])
                    gk_maps.append(np.array(
                        [sk.get(tuple(m), -1)
                         for m in ctx.gkvec.millers[ik][:nk_now]],
                        dtype=np.int64,
                    ))

        def remap_g(a):
            if g_map is None:
                return a
            o = np.zeros(a.shape[:-1] + (len(g_map),), dtype=a.dtype)
            ok = g_map >= 0
            o[..., ok] = a[..., g_map[ok]]
            return o

        if "density" not in f or "rho_g" not in f["density"]:
            raise CheckpointError(
                "checkpoint validation failed on field 'density/rho_g': "
                "dataset missing"
            )
        out["rho_g"] = remap_g(f["density/rho_g"][...])
        if "mag_g" in f["density"]:
            out["mag_g"] = remap_g(f["density/mag_g"][...])
        if "paw_dm" in f["density"]:
            out["paw_dm"] = f["density/paw_dm"][...]
        if "potential" in f:
            out["veff_g"] = remap_g(f["potential/veff_g"][...])
            if "bz_g" in f["potential"]:
                out["bz_g"] = remap_g(f["potential/bz_g"][...])
        if "kset" in f and (g_map is None or gk_maps is not None):
            psi = f["kset/psi"][...]
            if gk_maps is not None:
                new = np.zeros(
                    psi.shape[:-1] + (ctx.gkvec.ngk_max,), dtype=psi.dtype
                )
                for ik, mp in enumerate(gk_maps):
                    idx = np.nonzero(mp >= 0)[0]
                    new[ik][..., idx] = psi[ik][..., mp[idx]]
                psi = new
            out["psi"] = psi
            for k in ("band_energies", "band_occupancies"):
                if k in f["kset"]:
                    out[k] = f["kset"][k][...]
        for gname in ("scf", "md"):
            # mid-SCF / MD state rides the exact G enumeration it was saved
            # with: a remapped (strained) restart invalidates the packed
            # mixer vector and the extrapolation histories, so these groups
            # are only returned on exact match
            if gname in f and g_map is None:
                sg = f[gname]
                payload: dict = {
                    k: v.decode() if isinstance(v, bytes) else v
                    for k, v in sg.attrs.items()
                }
                for k in sg:
                    payload[k] = sg[k][...]
                out[gname] = payload
    return out


def validate_checkpoint(path: str) -> bool:
    """Cheap context-free validity probe: file opens as HDF5, has /meta,
    readable schema version, and (when recorded) an intact sha256 digest.
    Used by the serving engine / restart task to pick a resume candidate
    without building a SimulationContext first."""
    if not os.path.exists(path):
        return False
    try:
        with h5.File(path, "r") as f:
            if "meta" not in f:
                return False
            if int(f["meta"].attrs.get("version", 1)) > SCHEMA_VERSION:
                return False
            if "sha256" in f["meta"].attrs:
                if _content_digest(f) != str(f["meta"].attrs["sha256"]):
                    return False
    except OSError:
        return False
    return True


def find_resumable(path: str, keep: int = 0) -> str | None:
    """Newest valid snapshot in the rotation ``path, path.1, ...``.

    Returns None when no generation validates (fresh start). ``keep``
    bounds the generations probed beyond any that exist on disk."""
    candidates = [path] + [f"{path}.{i}" for i in range(1, max(keep, 1))]
    for p in candidates:
        if validate_checkpoint(p):
            return p
    # probe a few extra generations in case keep was lowered between runs
    i = max(keep, 1)
    while os.path.exists(f"{path}.{i}") and i < 100:
        if validate_checkpoint(f"{path}.{i}"):
            return f"{path}.{i}"
        i += 1
    return None
