"""sirius_tpu_torch/io/h5.py against h5py: a file the port writes reads
back through h5py bit for bit (values, dtypes, shapes, attributes, the
visit order), and a file h5py writes reads back through the port the same
way, over every dtype of the subset, ranks 0 to 4, zero-size data, and
int, float, bool and str attributes (scalars and arrays). Also the parts
other writers use: object headers continued in several blocks (h5py's own
groups, and the port's past MAX_CHUNK), group B-trees of more than one
node; a truncated file and a file that is not HDF5 raise OSError."""

import h5py
import numpy as np
import pytest

from sirius_tpu_torch.io import h5

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64", "float32", "float64", "complex64", "complex128", "bool"]
SHAPES = [(0,), (3,), (2, 3), (2, 0, 3), (2, 3, 1, 4)]


def sample(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) > 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, size=shape, dtype=dt,
                            endpoint=True)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_port_writes_h5py_reads(tmp_path, dtype, shape):
    a = sample(dtype, shape)
    path = tmp_path / "p.h5"
    with h5.File(path, "w") as f:
        f.create_group("g").create_dataset("a", data=a)
    with h5py.File(path, "r") as f:
        got = f["g/a"][...]
    assert same(got, a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [()] + SHAPES,
                         ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_h5py_writes_port_reads(tmp_path, dtype, shape):
    a = sample(dtype, shape, seed=1)
    path = tmp_path / "h.h5"
    with h5py.File(path, "w") as f:
        f.create_group("g").create_dataset("a", data=a)
    with h5.File(path, "r") as f:
        ds = f["g/a"]
        assert ds.shape == a.shape and ds.dtype == a.dtype
        got = ds[...]
    assert same(got, a)


ATTRS = {
    "int": 7, "neg": np.int32(-3), "float": 20.0, "f32": np.float32(1.5),
    "bool": np.bool_(True), "false": False, "str": "anderson",
    "utf8": "ångström", "empty_str": "",
    "ints": np.arange(5, dtype=np.int64), "floats": np.linspace(0, 1, 4),
    "cplx": np.complex128(1 - 2j), "matrix": np.eye(3),
    "strs": np.array(["a", "bc"], dtype=object),
}


def check_attrs(got):
    for k, v in ATTRS.items():
        g = got[k]
        if isinstance(v, str):
            assert isinstance(g, str) and g == v, k
        elif isinstance(v, np.ndarray) and v.dtype == object:
            assert list(g) == list(v), k
        else:
            want = np.asarray(v)
            assert same(g, want), (k, g, want)
            assert np.ndim(g) == want.ndim, k


def test_attributes_both_ways(tmp_path):
    p_path, h_path = tmp_path / "p.h5", tmp_path / "h.h5"
    with h5.File(p_path, "w") as f:
        g = f.create_group("meta")
        for k, v in ATTRS.items():
            g.attrs[k] = v
    with h5py.File(p_path, "r") as f:
        got = dict(f["meta"].attrs)
    got = {k: (v.decode() if isinstance(v, bytes) else v)
           for k, v in got.items()}
    got["strs"] = [s.decode() if isinstance(s, bytes) else s
                   for s in got["strs"]]
    check_attrs(got)
    with h5py.File(h_path, "w") as f:
        g = f.create_group("meta")
        for k, v in ATTRS.items():
            g.attrs[k] = v
    with h5.File(h_path, "r") as f:
        check_attrs(dict(f["meta"].attrs))


def build_tree(f):
    root = f.create_group("b")
    root.create_dataset("z", data=np.arange(3.0))
    sub = root.create_group("a")
    sub.create_dataset("y", data=np.ones((2, 2), dtype=np.int32))
    f.create_group("a").create_dataset("x", data=np.zeros(0))
    f.create_dataset("c", data=np.array([1 + 1j]))
    f["b"].attrs["n"] = 3


def test_visit_order_and_membership(tmp_path):
    p_path, h_path = tmp_path / "p.h5", tmp_path / "h.h5"
    with h5.File(p_path, "w") as f:
        build_tree(f)
    with h5py.File(h_path, "w") as f:
        build_tree(f)
    for path in (p_path, h_path):
        with h5py.File(path, "r") as f:
            want = []
            f.visit(want.append)
        with h5.File(path, "r") as f:
            got = []
            f.visit(got.append)
            assert "b/a/y" in f and "/b/z" in f and "b/q" not in f
            assert list(f) == ["a", "b", "c"]
            assert f["b"].attrs["n"] == 3
        assert got == want


def test_long_header_continues(tmp_path, monkeypatch):
    # past MAX_CHUNK bytes of messages the writer continues the header in
    # further blocks; h5py follows them
    monkeypatch.setattr(h5, "MAX_CHUNK", 256)
    path = tmp_path / "p.h5"
    with h5.File(path, "w") as f:
        g = f.create_group("g")
        for i in range(40):
            g.attrs[f"a{i:02d}"] = float(i)
        g.create_dataset("d", data=np.arange(4))
        g["d"].attrs["s"] = "x" * 300
    with h5py.File(path, "r") as f:
        assert [f["g"].attrs[f"a{i:02d}"] for i in range(40)] == list(
            map(float, range(40)))
        assert f["g/d"].attrs["s"] == "x" * 300
    with h5.File(path, "r") as f:
        assert f["g"].attrs["a39"] == 39.0


def test_many_members_and_multinode_btrees(tmp_path):
    # the writer raises the leaf K so one node holds a large group; h5py
    # splits such a group over many nodes and two B-tree levels, which
    # the reader walks
    names = [f"d{i:04d}" for i in range(700)]
    p_path, h_path = tmp_path / "p.h5", tmp_path / "h.h5"
    for path, lib in ((p_path, h5), (h_path, h5py)):
        with lib.File(path, "w") as f:
            g = f.create_group("big")
            for i, n in enumerate(names):
                g.create_dataset(n, data=np.array([i]))
    with h5py.File(p_path, "r") as f:
        assert sorted(f["big"]) == names
        assert int(f["big/d0123"][0]) == 123
    with h5.File(h_path, "r") as f:
        assert list(f["big"]) == names
        assert all(int(f["big"][n][0]) == i for i, n in enumerate(names))


@pytest.mark.parametrize("cut", [0.5, 0.95])
def test_truncated_file_raises(tmp_path, cut):
    path = tmp_path / "p.h5"
    with h5.File(path, "w") as f:
        f.create_group("g").create_dataset("a", data=np.arange(1000.0))
        f["g"].attrs["s"] = "text"
    data = path.read_bytes()
    path.write_bytes(data[:int(len(data) * cut)])
    with pytest.raises(OSError):
        with h5.File(path, "r") as f:
            f["g/a"][...]
    with pytest.raises(OSError):
        h5py.File(path, "r")


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"not an hdf5 file" * 64)
    with pytest.raises(OSError):
        h5.File(path, "r")
    path.write_bytes(b"")
    with pytest.raises(OSError):
        h5.File(path, "r")


def test_outside_the_subset_raises(tmp_path):
    with h5.File(tmp_path / "p.h5", "w") as f:
        with pytest.raises(TypeError):
            f.create_dataset("s", data=np.array(["a"]))
        with pytest.raises(TypeError):
            f.attrs["h"] = np.float16(1.0)
        with pytest.raises(ValueError):
            f.create_dataset("x", data=np.float64(1.0))
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("c", data=np.arange(100.0), chunks=(10,))
    with pytest.raises(OSError):
        h5.File(tmp_path / "c.h5", "r")
