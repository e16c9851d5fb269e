"""Port parity: the UPF v2 reader (sirius_tpu_torch/io/upf.py, a copy of
the JAX package's io/upf.py). The in-test UPF strings of tests/test_upf.py
go through both packages' upf2_to_json: the dicts must be equal, and each
malformed case raises the port's UpfParseError (a ValueError) naming the
same field as the JAX package's. The synthetic species written as UPF
(sirius_tpu_torch/testing.py::write_upf: norm-conserving, ultrasoft and
spin-orbit) parse to equal dicts in both packages, and AtomType.from_file
on the .upf gives the arrays of the JSON route bit for bit."""

import os

import numpy as np
import pytest

from sirius_tpu.io import upf as jax_upf
from sirius_tpu_torch.crystal.atom_type import AtomType
from sirius_tpu_torch.io import upf
from sirius_tpu_torch.testing import (synthetic_silicon_species,
                                      synthetic_silicon_type, write_upf)
from tests.test_upf import MINIMAL_OK

MALFORMED = [
    (lambda s: s[: len(s) // 2], "XML"),
    (lambda s: s.replace("<UPF ", "<QE_PP ").replace("</UPF>", "</QE_PP>"),
     "UPF"),
    (lambda s: s.replace(' z_valence="4.0"', ""), "PP_HEADER/z_valence"),
    (lambda s: s.replace('mesh_size="3"', 'mesh_size="three"'),
     "PP_HEADER/mesh_size"),
    (lambda s: s.replace("<PP_MESH><PP_R>0.0 0.1 0.2</PP_R></PP_MESH>",
                         "<PP_MESH/>"), "PP_MESH/PP_R"),
    (lambda s: s.replace("0.0 0.5 0.0", "0.0 oops 0.0"),
     "PP_NONLOCAL/PP_BETA.1"),
    (lambda s: s.replace(' angular_momentum="0"', ""),
     "PP_BETA.1/angular_momentum"),
    (lambda s: s.replace("<PP_NONLOCAL>", "<PP_IGNORED>")
               .replace("</PP_NONLOCAL>", "</PP_IGNORED>"), "PP_NONLOCAL"),
    (lambda s: "<UPF version='2.0.1'></UPF>", "PP_HEADER"),
]
SPECIES = {"nc": dict(ultrasoft=False), "us": dict(ultrasoft=True),
           "so_nc": dict(ultrasoft=False, spin_orbit=True),
           "so_us": dict(ultrasoft=True, spin_orbit=True)}


def write(tmp_path, body: str) -> str:
    p = tmp_path / "species.UPF"
    p.write_text(body)
    return str(p)


def test_minimal_upf_parses_to_the_jax_dict(tmp_path):
    path = write(tmp_path, MINIMAL_OK)
    got = upf.upf2_to_json(path)
    assert got == jax_upf.upf2_to_json(path)
    assert got["pseudo_potential"]["D_ion"] == [1.0]  # Ry -> Ha


@pytest.mark.parametrize("mutate,field", MALFORMED)
def test_malformed_upf_raises_the_same_field(tmp_path, mutate, field):
    path = write(tmp_path, mutate(MINIMAL_OK))
    with pytest.raises(upf.UpfParseError) as ours:
        upf.upf2_to_json(path)
    with pytest.raises(jax_upf.UpfParseError) as theirs:
        jax_upf.upf2_to_json(path)
    assert isinstance(ours.value, ValueError)
    assert field in ours.value.field
    assert ours.value.field == theirs.value.field
    assert str(ours.value) == str(theirs.value)


def test_convert_writes_the_json_beside(tmp_path):
    path = write(tmp_path, MINIMAL_OK)
    assert upf.main([path]) == 0
    assert os.path.exists(path + ".json")
    assert upf.main([]) == 2


def assert_same_type(a, b):
    for name in ("r", "vloc", "d_ion", "rho_total"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.zn, a.pseudo_type, a.core_correction, a.rho_core) == (
        b.zn, b.pseudo_type, b.core_correction, b.rho_core)
    assert [(x.l, x.j, x.nr) for x in a.beta] == [(x.l, x.j, x.nr)
                                                   for x in b.beta]
    for x, y in zip(a.beta, b.beta):
        np.testing.assert_array_equal(x.rbeta, y.rbeta)
    assert [(x.i, x.j, x.l) for x in a.augmentation] == [
        (x.i, x.j, x.l) for x in b.augmentation]
    for x, y in zip(a.augmentation, b.augmentation):
        np.testing.assert_array_equal(x.qr, y.qr)
    assert [(w.l, w.occupation) for w in a.atomic_wfs] == [
        (w.l, w.occupation) for w in b.atomic_wfs]
    for x, y in zip(a.atomic_wfs, b.atomic_wfs):
        np.testing.assert_array_equal(x.chi, y.chi)


@pytest.mark.parametrize("kind", sorted(SPECIES))
def test_written_species_parse_alike(tmp_path, kind):
    species = synthetic_silicon_species(**SPECIES[kind])
    path = write_upf(species, str(tmp_path / "Si.upf"))
    got = upf.upf2_to_json(path)
    assert got == jax_upf.upf2_to_json(path)
    header = got["pseudo_potential"]["header"]
    assert header["spin_orbit"] == ("so" in kind)
    from_json = AtomType.from_dict("Si", species)
    from_upf = AtomType.from_file("Si", path)
    assert_same_type(from_upf, from_json)
    assert from_upf.spin_orbit == ("so" in kind)
    if "so" not in kind:
        # the JSON layout of the synthetic species rebuilds its type
        assert_same_type(from_json, synthetic_silicon_type(**SPECIES[kind]))
    else:
        assert [(b.l, b.j) for b in from_upf.beta] == [(0, 0.5), (1, 0.5),
                                                       (1, 1.5)]
        assert len(from_upf.augmentation) == (4 if kind == "so_us" else 0)
