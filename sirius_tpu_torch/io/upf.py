"""UPF v2 (XML) pseudopotential reader -> SIRIUS-layout JSON dict.

A copy of sirius_tpu/io/upf.py (host Python, no device work): the same
parser, the same layout and the same UpfParseError, so a UPF species file
gives both packages the same dict (tests/test_torch_upf.py holds them
equal). crystal/atom_type.py::AtomType.from_file converts a ``.upf`` path
with it in process.

Unit conventions of the JSON layout (those of the reference converter's
pre-converted <name>.UPF.json files):
  - local_potential, D_ion, paw ae_local_potential: Ry -> Ha (x 0.5)
  - radial grid, beta, chi, rho_atom, nlcc, augmentation Q: unchanged
  - beta_projectors truncated at their cutoff_radius_index
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


class UpfParseError(ValueError):
    """Typed parse failure naming the offending UPF field.

    Raised for truncated/malformed files so callers (the serving engine in
    particular) can classify the job as permanently failed instead of
    crashing mid-SCF on a bare AttributeError/ValueError. ``field`` is the
    UPF element or attribute that was missing or unparseable.
    """

    def __init__(self, path: str, field: str, detail: str):
        self.path = path
        self.field = field
        self.detail = detail
        super().__init__(f"{path}: UPF parse error in '{field}': {detail}")


def _require(root, tag: str, path: str):
    el = root.find(tag)
    if el is None:
        raise UpfParseError(path, tag, "required element missing")
    return el


def _floats(el, field: str = "?", path: str = "?") -> list:
    if el is None:
        raise UpfParseError(path, field, "required element missing")
    if el.text is None:
        raise UpfParseError(path, field, "element has no numeric data")
    try:
        return [float(x) for x in el.text.split()]
    except ValueError as e:
        raise UpfParseError(path, field, f"non-numeric data: {e}") from None


def _attrib(el, name, default=None):
    v = el.attrib.get(name, default)
    return v.strip() if isinstance(v, str) else v


def _bool(v) -> bool:
    return str(v).strip().upper() in ("T", "TRUE", ".TRUE.", "1")


def _header_field(h: dict, name: str, conv, path: str):
    if name not in h:
        raise UpfParseError(path, f"PP_HEADER/{name}",
                            "required attribute missing")
    try:
        return conv(h[name])
    except ValueError as e:
        raise UpfParseError(path, f"PP_HEADER/{name}",
                            f"unparseable value {h[name]!r}: {e}") from None


def upf2_to_json(path: str) -> dict:
    """Parse a UPF v2 file into the SIRIUS pseudo_potential JSON layout.

    Raises UpfParseError (a ValueError subclass) on truncated or malformed
    input, naming the offending element/attribute.
    """
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise UpfParseError(path, "XML", f"malformed/truncated XML: {e}") \
            from None
    if root.tag != "UPF":
        raise UpfParseError(path, "UPF",
                            f"not a UPF v2 file (root tag {root.tag})")
    h = _require(root, "PP_HEADER", path).attrib

    pp: dict = {}
    header = {
        "element": _header_field(h, "element", str, path).strip(),
        "pseudo_type": _header_field(h, "pseudo_type", str, path).strip(),
        "core_correction": _bool(h.get("core_correction", "F")),
        "z_valence": _header_field(h, "z_valence", float, path),
        "mesh_size": _header_field(h, "mesh_size", int, path),
        "number_of_wfc": int(h.get("number_of_wfc", 0)),
        "number_of_proj": int(h.get("number_of_proj", 0)),
        "is_ultrasoft": _bool(h.get("is_ultrasoft", "F")),
        "spin_orbit": _bool(h.get("has_so", "F")),
        "original_upf_file": path.rsplit("/", 1)[-1],
    }

    r = np.asarray(_floats(root.find("PP_MESH/PP_R"), "PP_MESH/PP_R", path))
    pp["radial_grid"] = r.tolist()
    vloc = root.find("PP_LOCAL")
    if vloc is not None:
        pp["local_potential"] = (
            0.5 * np.asarray(_floats(vloc, "PP_LOCAL", path))
        ).tolist()
    nlcc = root.find("PP_NLCC")
    if nlcc is not None:
        pp["core_charge_density"] = _floats(nlcc, "PP_NLCC", path)
    rho = root.find("PP_RHOATOM")
    if rho is not None:
        pp["total_charge_density"] = _floats(rho, "PP_RHOATOM", path)

    # --- beta projectors (truncated at their cutoff index) ---
    nproj = header["number_of_proj"]
    nl = root.find("PP_NONLOCAL")
    if nl is None and nproj > 0:
        raise UpfParseError(path, "PP_NONLOCAL",
                            f"missing but header declares {nproj} projectors")
    betas = []
    max_cri = 0
    for i in range(1, nproj + 1):
        b = nl.find(f"PP_BETA.{i}")
        vals = _floats(b, f"PP_NONLOCAL/PP_BETA.{i}", path)
        cri = _attrib(b, "cutoff_radius_index")
        n = int(cri) if cri else len(vals)
        max_cri = max(max_cri, n)
        l_attr = _attrib(b, "angular_momentum")
        if l_attr is None:
            raise UpfParseError(
                path, f"PP_NONLOCAL/PP_BETA.{i}/angular_momentum",
                "required attribute missing")
        entry = {
            "radial_function": vals[:n],
            "angular_momentum": int(l_attr),
        }
        lab = _attrib(b, "label")
        if lab:
            entry["label"] = lab
        j = _attrib(b, "total_angular_momentum")
        if j is not None and header["spin_orbit"]:
            entry["total_angular_momentum"] = float(j)
        betas.append(entry)
    pp["beta_projectors"] = betas
    dij = nl.find("PP_DIJ") if nl is not None else None
    if dij is not None:
        pp["D_ion"] = (
            0.5 * np.asarray(_floats(dij, "PP_NONLOCAL/PP_DIJ", path))
        ).tolist()

    # --- augmentation (US/PAW): Q_ij^l(r) with q_with_l ---
    aug_el = nl.find("PP_AUGMENTATION") if nl is not None else None
    if aug_el is not None and _bool(_attrib(aug_el, "q_with_l", "F")):
        aug = []
        ls = [b["angular_momentum"] for b in betas]
        for i in range(nproj):
            for j in range(i, nproj):
                for l in range(abs(ls[i] - ls[j]), ls[i] + ls[j] + 1, 2):
                    q = aug_el.find(f"PP_QIJL.{i + 1}.{j + 1}.{l}")
                    if q is None:
                        continue
                    aug.append({
                        "i": i,
                        "j": j,
                        "angular_momentum": l,
                        "radial_function": _floats(
                            q, f"PP_QIJL.{i + 1}.{j + 1}.{l}", path),
                    })
        pp["augmentation"] = aug

    # --- atomic wave functions ---
    wfc = root.find("PP_PSWFC")
    wfs = []
    if wfc is not None:
        for i in range(1, header["number_of_wfc"] + 1):
            c = wfc.find(f"PP_CHI.{i}")
            if c is None:
                continue
            # NOTE: the reference converter keeps beta labels but DROPS the
            # chi labels (checked against the shipped .UPF.json files)
            wfs.append({
                "radial_function": _floats(c, f"PP_CHI.{i}", path),
                "angular_momentum": int(_attrib(c, "l")),
                "occupation": float(_attrib(c, "occupation", 0.0)),
            })
    pp["atomic_wave_functions"] = wfs

    # --- PAW block ---
    paw_el = root.find("PP_PAW")
    full_wfc = root.find("PP_FULL_WFC")
    if paw_el is not None:
        ce = _attrib(paw_el, "core_energy")
        if ce is not None:
            header["paw_core_energy"] = 0.5 * float(ce)
        cri = _attrib(aug_el, "cutoff_r_index") if aug_el is not None else None
        header["cutoff_radius_index"] = int(cri) if cri else max_cri
        pd: dict = {}
        occ = paw_el.find("PP_OCCUPATIONS")
        if occ is not None:
            pd["occupations"] = _floats(occ, "PP_PAW/PP_OCCUPATIONS", path)
        ae_nlcc = paw_el.find("PP_AE_NLCC")
        if ae_nlcc is not None:
            pd["ae_core_charge_density"] = _floats(
                ae_nlcc, "PP_PAW/PP_AE_NLCC", path)
        ae_vloc = paw_el.find("PP_AE_VLOC")
        if ae_vloc is not None:
            pd["ae_local_potential"] = (
                0.5 * np.asarray(_floats(ae_vloc, "PP_PAW/PP_AE_VLOC", path))
            ).tolist()
        if full_wfc is not None:
            ae, ps = [], []
            for i in range(1, nproj + 1):
                a = full_wfc.find(f"PP_AEWFC.{i}")
                p_ = full_wfc.find(f"PP_PSWFC.{i}")
                if a is not None:
                    ae.append({
                        "radial_function": _floats(a, f"PP_AEWFC.{i}", path),
                        "angular_momentum": int(_attrib(a, "l")),
                    })
                if p_ is not None:
                    ps.append({
                        "radial_function": _floats(p_, f"PP_PSWFC.{i}", path),
                        "angular_momentum": int(_attrib(p_, "l")),
                    })
            pd["ae_wfc"] = ae
            pd["ps_wfc"] = ps
        # aug integrals/multipoles from the augmentation block
        if aug_el is not None:
            q = aug_el.find("PP_Q")
            if q is not None:
                pd["aug_integrals"] = _floats(q, "PP_AUGMENTATION/PP_Q", path)
            m = aug_el.find("PP_MULTIPOLES")
            if m is not None:
                pd["aug_multipoles"] = _floats(m, "PP_AUGMENTATION/PP_MULTIPOLES", path)
        pp["paw_data"] = pd

    pp["header"] = header
    return {"pseudo_potential": pp}


def convert(path: str, out_path: str | None = None) -> str:
    """Convert a UPF v2 file; writes <path>.json unless out_path given."""
    import json

    data = upf2_to_json(path)
    out = out_path or path + ".json"
    with open(out, "w") as f:
        json.dump(data, f)
    return out


def main(argv=None) -> int:
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m sirius_tpu_torch.io.upf <file.UPF> [out.json]")
        return 2
    out = convert(args[0], args[1] if len(args) > 1 else None)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
