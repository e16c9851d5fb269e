"""The subset of HDF5 that the checkpoint schema uses, read and written in
numpy, with no HDF5 library.

io/checkpoint.py writes sirius.h5 and the mid-SCF autosave in the JAX
package's schema (sirius_tpu/io/checkpoint.py, which writes them through
h5py); this module gives it the few h5py calls it makes (``File``,
``create_group``, ``create_dataset``, ``attrs``, ``visit``, ``in``,
``[...]``) so the two modules read line for line alike, and the files pass
both ways between the packages.

What it writes (the layout h5py gives these files by default):
  - superblock version 0, 8-byte offsets and lengths; the group leaf K is
    raised so that every group fits one symbol-table node;
  - "old-style" groups: a symbol-table message, a version 1 B-tree (TREE,
    one leaf), a local heap (HEAP) with the link names, one symbol-table
    node (SNOD) with the entries in name order;
  - version 1 object headers, split by continuation messages where a
    header's messages pass MAX_CHUNK bytes;
  - datasets: dataspace (version 1, rank 1-32, with max dims), datatype,
    fill value (version 2, the library default) and contiguous layout
    (version 3; a zero-size dataset has no storage, the undefined address);
  - attributes (version 1 messages): scalars (rank 0) and arrays;
  - datatypes: little-endian signed and unsigned integers of 1, 2, 4 and
    8 bytes, IEEE float32 and float64, complex64 / complex128 as the
    compound {r, i} h5py reads back as complex, bool as h5py's enum over
    int8 {FALSE, TRUE}, and str as a variable-length UTF-8 string whose
    bytes sit in a global heap collection (GCOL).

What it reads: the same, plus what other writers put in such files:
B-trees of more than one node, object headers continued in several
blocks (h5py adds an attribute after a header was written), NIL and any
other message it does not need (skipped by its size), the old and the
shared fill-value messages, compact layouts, big-endian numbers, fixed-
length strings (as numpy bytes) and superblock version 1. Anything else
(chunked or compressed datasets, new-style groups, superblock 2 and 3)
raises OSError, as does a file that is truncated or is not HDF5.

Arrays are written from a C-contiguous view of the caller's array, with
no copy: the array must not change between create_dataset and close.
Datasets are read from the file when indexed (``ds[...]``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
# the local heap's end of its free list (the HDF5 library's H5HL_FREE_NULL)
FREE_NULL = 1
# group B-tree internal node K (the library default); every node the
# writer makes is a leaf
INTERNAL_K = 16
MIN_LEAF_K = 4
# a global heap collection is at least this large (the library's minimum)
GCOL_MIN = 4096
# the largest object header chunk the writer makes before continuing
MAX_CHUNK = 65536

# message types
MSG_NIL = 0x0000
MSG_DATASPACE = 0x0001
MSG_DATATYPE = 0x0003
MSG_FILL = 0x0005
MSG_LAYOUT = 0x0008
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011

_BOOL = np.dtype(np.bool_)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


# ---------------------------------------------------------------------------
# the tree: groups, datasets, attributes
# ---------------------------------------------------------------------------


class Attributes(dict):
    """A node's attributes, name -> value. Writing stores the value as h5py
    would write it (str stays str, numbers become numpy scalars or arrays);
    reading gives what h5py gives (str for a variable-length string, numpy
    scalars and arrays otherwise)."""

    def __init__(self, writable: bool):
        super().__init__()
        self._writable = writable

    def __setitem__(self, name, value):
        if not self._writable:
            raise OSError("attributes of a file opened for reading are "
                          "read-only")
        super().__setitem__(str(name), _attr_value(value))


def _attr_value(value):
    if isinstance(value, (str, np.str_)):
        return str(value)
    a = np.asarray(value)
    if a.dtype.kind == "U":
        return a.astype(object) if a.ndim else str(a[()])
    if a.dtype == object:
        if not all(isinstance(v, str) for v in a.ravel()):
            raise TypeError("object attributes must hold str only")
        return a if a.ndim else str(a[()])
    _datatype(a.dtype)  # raises for a type outside the subset
    return a[()] if a.ndim == 0 else np.ascontiguousarray(a)


class Node:
    def __init__(self, file, name: str):
        self.file = file
        self.name = name
        self.attrs = Attributes(file.mode == "w")


class Dataset(Node):
    """A dataset: shape, dtype, attrs; ``ds[...]`` reads (or, on a file
    being written, returns) its array."""

    def __init__(self, file, name, shape, dtype, data=None, addr=UNDEF,
                 decode=None):
        super().__init__(file, name)
        self.shape = tuple(int(n) for n in shape)
        self.dtype = np.dtype(dtype)
        self._data = data
        self._addr = addr
        self._decode = decode  # (raw dtype, post) of a dataset on disk

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __getitem__(self, key):
        a = self._data if self._data is not None else self._read()
        if key is Ellipsis or key == ():
            return a
        return a[key]

    def _read(self) -> np.ndarray:
        raw, post = self._decode
        n = self.size
        if n == 0:
            return np.zeros(self.shape, dtype=self.dtype)
        if isinstance(self._addr, bytes):  # compact layout
            a = np.frombuffer(self._addr, dtype=raw, count=n).copy()
        else:
            # straight from the file into the array, no intermediate copy
            a = np.empty(n, dtype=raw)
            self.file._fh.seek(self._addr)
            if self.file._fh.readinto(a.view(np.uint8)) != a.nbytes:
                raise OSError(f"{self.file.path}: dataset {self.name} runs "
                              "past the end of the file (truncated file)")
        return post(a).reshape(self.shape)


class Group(Node):
    """A group: its members by name (``g["a/b"]``, ``"a/b" in g``,
    iteration in name order), ``visit`` and, while writing,
    ``create_group`` / ``create_dataset``."""

    def __init__(self, file, name):
        super().__init__(file, name)
        self._members: dict[str, Node] = {}

    def _walk(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._members:
                return None
            node = node._members[part]
        return node

    def __getitem__(self, path: str):
        node = self.file if path.startswith("/") else self
        node = node._walk(path)
        if node is None:
            raise KeyError(f"no object '{path}' in {self.name}")
        return node

    def __contains__(self, path) -> bool:
        node = self.file if str(path).startswith("/") else self
        return node._walk(str(path)) is not None

    def __iter__(self):
        return iter(sorted(self._members))

    def visit(self, fn):
        """Call fn(name) on every member below this group, names relative
        to it, in h5py's order (name order, a group before its members);
        stop and return fn's value where it is not None."""
        for k in self:
            node = self._members[k]
            out = fn(k)
            if out is not None:
                return out
            if isinstance(node, Group):
                out = node.visit(lambda n, k=k: fn(f"{k}/{n}"))
                if out is not None:
                    return out
        return None

    def _new(self, name: str, make):
        if self.file.mode != "w":
            raise OSError(f"{self.file.path} is open for reading")
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError("empty name")
        parent = self
        for part in parts[:-1]:
            nxt = parent._members.get(part)
            if nxt is None:
                nxt = parent.create_group(part)
            if not isinstance(nxt, Group):
                raise ValueError(f"'{part}' is a dataset, not a group")
            parent = nxt
        if parts[-1] in parent._members:
            raise ValueError(f"'{name}' exists already in {self.name}")
        path = parent.name.rstrip("/") + "/" + parts[-1]
        node = make(path)
        parent._members[parts[-1]] = node
        return node

    def create_group(self, name: str) -> "Group":
        return self._new(name, lambda path: Group(self.file, path))

    def create_dataset(self, name: str, data=None) -> Dataset:
        a = np.asarray(data)
        if a.dtype.kind == "U":
            raise TypeError("string datasets are outside the subset "
                            "(store text as an attribute)")
        _datatype(a.dtype)
        if a.ndim == 0:
            raise ValueError("scalar datasets are outside the subset "
                             "(store a scalar as an attribute)")
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        a = np.ascontiguousarray(a)
        return self._new(name, lambda path: Dataset(self.file, path, a.shape,
                                                    a.dtype, data=a))


class File(Group):
    """An HDF5 file: mode "r" reads an existing file, "w" writes a new one
    at close (or at the end of a ``with`` block)."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode must be 'r' or 'w', got '{mode}'")
        self.path = os.fspath(path)
        self.mode = mode
        super().__init__(self, "/")
        self._fh = None
        if mode == "r":
            self._fh = open(self.path, "rb")
            try:
                _Reader(self).read()
            except OSError:
                self._fh.close()
                raise
            except (struct.error, ValueError, KeyError, IndexError,
                    OverflowError, UnicodeDecodeError) as e:
                self._fh.close()
                raise OSError(f"{self.path}: not a readable HDF5 file "
                              f"({type(e).__name__}: {e})") from e

    def close(self) -> None:
        if self.mode == "w":
            if self._fh is None:
                self._fh = False  # written once
                _Writer(self).write(self.path)
        elif self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self.mode == "w":
            self._fh = False  # an error while building: write nothing
            return False
        self.close()
        return False


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------


def _int_type(size: int, signed: bool, big: bool = False) -> bytes:
    bits = (0x01 if big else 0) | (0x08 if signed else 0)
    return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
            + struct.pack("<HH", 0, 8 * size))


def _float_type(size: int) -> bytes:
    if size == 8:
        sign, exp_loc, exp_size, mant_size, bias = 63, 52, 11, 52, 1023
    elif size == 4:
        sign, exp_loc, exp_size, mant_size, bias = 31, 23, 8, 23, 127
    else:
        raise TypeError(f"float{8 * size} is outside the subset")
    return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0,
                          mant_size, bias))


def _compound_member(name: str, offset: int, member: bytes) -> bytes:
    # version 1 member: padded name, offset, dimensionality 0, reserved,
    # permutation, reserved, four dimension sizes, then its type
    return (_padded(name.encode() + b"\0") + struct.pack("<I", offset)
            + b"\0" * 28 + member)


def _datatype(dt: np.dtype) -> bytes:
    """The datatype message of a numpy dtype of the subset."""
    dt = np.dtype(dt)
    if dt == _BOOL:
        base = _int_type(1, True)
        return (bytes([0x18, 2, 0, 0]) + struct.pack("<I", 1) + base
                + _padded(b"FALSE\0") + _padded(b"TRUE\0") + b"\x00\x01")
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return _int_type(dt.itemsize, dt.kind == "i")
    if dt.kind == "f" and dt.itemsize in (4, 8):
        return _float_type(dt.itemsize)
    if dt.kind == "c" and dt.itemsize in (8, 16):
        half = dt.itemsize // 2
        f = _float_type(half)
        return (bytes([0x16, 2, 0, 0]) + struct.pack("<I", dt.itemsize)
                + _compound_member("r", 0, f) + _compound_member("i", half, f))
    raise TypeError(f"numpy dtype {dt} is outside the HDF5 subset of "
                    "io/h5.py")


# a variable-length UTF-8 string: 16 bytes an element (length, collection
# address, object index) over unsigned 8-bit characters
_VLEN_STR_TYPE = (bytes([0x19, 0x01, 0x01, 0]) + struct.pack("<I", 16)
                  + _int_type(1, False))


class _Type:
    """A parsed datatype: the numpy dtype h5py gives, the raw dtype of the
    stored bytes and the function from raw to the returned values."""

    def __init__(self, dtype, raw, post=None, vlen=False):
        self.dtype = np.dtype(dtype) if dtype is not object else object
        self.raw = np.dtype(raw)
        self.post = post or (lambda a: a)
        self.vlen = vlen


def _native(dt: np.dtype):
    """The values of stored dt in the machine's byte order (no copy where
    they are already)."""
    return lambda a: a.astype(dt.newbyteorder("="), copy=False)


def _parse_type(buf: bytes, p: int) -> tuple[_Type, int]:
    """Parse the datatype at buf[p:]; returns the type and the offset
    after it."""
    cv = buf[p]
    cls, version = cv & 0x0F, cv >> 4
    b0, b1, b2 = buf[p + 1], buf[p + 2], buf[p + 3]
    size = struct.unpack_from("<I", buf, p + 4)[0]
    q = p + 8
    if cls == 0:  # fixed point
        order = ">" if b0 & 1 else "<"
        kind = "i" if b0 & 0x08 else "u"
        dt = np.dtype(f"{order}{kind}{size}")
        return _Type(dt.newbyteorder("="), dt, _native(dt)), q + 4
    if cls == 1:  # floating point
        order = ">" if b0 & 1 else "<"
        dt = np.dtype(f"{order}f{size}")
        return _Type(dt.newbyteorder("="), dt, _native(dt)), q + 12
    if cls == 3:  # fixed-length string
        dt = np.dtype(f"S{size}")
        return _Type(dt, dt), q
    if cls == 6:  # compound
        nmemb = b0 | (b1 << 8)
        names, offsets, types = [], [], []
        for _ in range(nmemb):
            end = buf.index(b"\0", q)
            names.append(buf[q:end].decode())
            if version < 3:
                q += _pad8(end + 1 - q)
                offsets.append(struct.unpack_from("<I", buf, q)[0])
                q += 4
                if version == 1:
                    q += 28
            else:
                q = end + 1
                nb = max(1, (size.bit_length() + 7) // 8)
                offsets.append(int.from_bytes(buf[q:q + nb], "little"))
                q += nb
            t, q = _parse_type(buf, q)
            types.append(t)
        if (names == ["r", "i"] and offsets[0] == 0
                and types[0].raw == types[1].raw and types[0].raw.kind == "f"
                and offsets[1] == types[0].raw.itemsize
                and size == 2 * types[0].raw.itemsize):
            order = types[0].raw.byteorder
            cdt = np.dtype(f"{order if order in '<>' else '<'}c{size}")
            return _Type(cdt.newbyteorder("="), cdt, _native(cdt)), q
        raw = np.dtype({"names": names, "formats": [t.raw for t in types],
                        "offsets": offsets, "itemsize": size})
        return _Type(raw, raw), q
    if cls == 8:  # enumeration
        nmemb = b0 | (b1 << 8)
        base, q = _parse_type(buf, q)
        names = []
        for _ in range(nmemb):
            end = buf.index(b"\0", q)
            names.append(buf[q:end].decode())
            q = end + 1 if version >= 3 else q + _pad8(end + 1 - q)
        values = np.frombuffer(buf, dtype=base.raw, count=nmemb, offset=q)
        q += nmemb * base.raw.itemsize
        if (sorted(zip(names, values.tolist()))
                == [("FALSE", 0), ("TRUE", 1)] and base.raw.itemsize == 1):
            return _Type(_BOOL, base.raw, lambda a: a.astype(_BOOL)), q
        return base, q
    if cls == 9:  # variable length
        base, q = _parse_type(buf, q)
        if b0 & 0x0F != 1:
            raise OSError("variable-length sequences are outside the subset")
        return _Type(object, np.dtype("V16"), vlen=True), q
    raise OSError(f"HDF5 datatype class {cls} is outside the subset")


def _dataspace(shape) -> bytes:
    rank = len(shape)
    head = bytes([1, rank, 1 if rank else 0, 0]) + b"\0" * 4
    dims = b"".join(struct.pack("<Q", int(n)) for n in shape)
    return head + dims + dims


def _parse_dataspace(buf: bytes, p: int) -> tuple:
    version, rank, flags = buf[p], buf[p + 1], buf[p + 2]
    if version == 1:
        q = p + 8
    elif version == 2:
        if buf[p + 3] == 2:  # null dataspace
            return None
        q = p + 4
    else:
        raise OSError(f"dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", buf, q)) if rank else ()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class _Writer:
    """Lays the tree out (every address known before any byte is written)
    and writes it: superblock, then each object's header, then each
    group's heap, B-tree and symbol-table node, the global heap, and the
    datasets' data."""

    def __init__(self, f: File):
        self.f = f
        self.groups: list[Group] = []
        self.datasets: list[Dataset] = []
        self._collect(f)
        most = max([len(g._members) for g in self.groups] + [1])
        self.leaf_k = max(MIN_LEAF_K, (most + 1) // 2)
        self.vlen: list[bytes] = []

    def _collect(self, g: Group):
        self.groups.append(g)
        for k in g:
            node = g._members[k]
            if isinstance(node, Group):
                self._collect(node)
            else:
                self.datasets.append(node)

    # -- sizes ---------------------------------------------------------

    def btree_size(self) -> int:
        return 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8

    def snod_size(self) -> int:
        return 8 + 2 * self.leaf_k * 40

    @staticmethod
    def heap_data(g: Group) -> tuple[bytes, dict]:
        data = b"\0" * 8
        offsets = {}
        for k in g:
            offsets[k] = len(data)
            data += _padded(k.encode() + b"\0")
        return data, offsets

    # -- messages ------------------------------------------------------

    def _attribute(self, name: str, value) -> bytes:
        nm = name.encode() + b"\0"
        if isinstance(value, str) or (isinstance(value, np.ndarray)
                                      and value.dtype == object):
            vals = [value] if isinstance(value, str) else list(value.ravel())
            dtype_msg = _VLEN_STR_TYPE
            shape = () if isinstance(value, str) else value.shape
            data = b""
            for v in vals:
                raw = str(v).encode()
                self.vlen.append(raw)
                data += struct.pack("<IQI", len(raw), self.gcol_addr,
                                    len(self.vlen))
        else:
            a = np.asarray(value)
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            dtype_msg = _datatype(a.dtype)
            shape = a.shape
            data = np.ascontiguousarray(a).tobytes()
        space = _dataspace(shape)
        return (bytes([1, 0]) + struct.pack("<HHH", len(nm), len(dtype_msg),
                                            len(space))
                + _padded(nm) + _padded(dtype_msg) + _padded(space) + data)

    def messages(self, node: Node) -> list[tuple[int, int, bytes]]:
        """(type, flags, data) of a node's header, in the library's order."""
        out = []
        if isinstance(node, Group):
            btree, heap = self.group_addr[node.name][1:3]
            out.append((MSG_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap)))
        else:
            out.append((MSG_DATASPACE, 0, _dataspace(node.shape)))
            out.append((MSG_DATATYPE, 1, _datatype(node.dtype)))
            out.append((MSG_FILL, 1, bytes([2, 2, 2, 1, 0, 0, 0, 0])))
            nbytes = node._data.nbytes
            addr = self.data_addr.get(node.name, UNDEF)
            out.append((MSG_LAYOUT, 0, bytes([3, 1])
                        + struct.pack("<QQ", addr, nbytes)))
        for k in sorted(node.attrs):
            out.append((MSG_ATTRIBUTE, 0, self._attribute(k, node.attrs[k])))
        return out

    @staticmethod
    def chunks(msgs) -> list[list[tuple[int, int, bytes]]]:
        """Split the messages into header chunks of at most MAX_CHUNK
        bytes, each but the last closed by a continuation message."""
        out, cur, size = [], [], 0
        for m in msgs:
            need = 8 + _pad8(len(m[2]))
            if cur and size + need + 24 > MAX_CHUNK:
                out.append(cur)
                cur, size = [], 0
            cur.append(m)
            size += need
        out.append(cur)
        return out

    @staticmethod
    def encode_chunk(msgs, cont=None) -> bytes:
        body = b""
        for mtype, flags, data in msgs:
            data = _padded(data)
            body += struct.pack("<HHB3x", mtype, len(data), flags) + data
        if cont is not None:
            body += struct.pack("<HHB3x", MSG_CONTINUATION, 16, 0)
            body += struct.pack("<QQ", *cont)
        return body

    def header(self, node: Node, addr: int) -> list[bytes]:
        """The encoded header of a node at addr, as its blocks: the first
        with the 16-byte prefix, then any continuation blocks, laid out
        one after the other."""
        chunks = self.chunks(self.messages(node))
        last = len(chunks) - 1
        sizes = [sum(8 + _pad8(len(m[2])) for m in c) + (24 if i < last else 0)
                 for i, c in enumerate(chunks)]
        nmsgs = sum(len(c) for c in chunks) + last
        starts = [addr + 16]
        for n in sizes[:-1]:
            starts.append(starts[-1] + n)
        blocks = [self.encode_chunk(c, (starts[i + 1], sizes[i + 1])
                                    if i < last else None)
                  for i, c in enumerate(chunks)]
        blocks[0] = (struct.pack("<BBHII4x", 1, 0, nmsgs, 1, sizes[0])
                     + blocks[0])
        return blocks

    # -- layout --------------------------------------------------------

    def layout(self) -> int:
        """Assign every address; returns the end of the file."""
        self.gcol_addr = 0
        # each group's header, B-tree, heap and symbol-table node
        self.group_addr: dict[str, list[int]] = {
            g.name: [0, 0, 0, 0] for g in self.groups}
        self.data_addr: dict[str, int] = {}
        self.header_addr: dict[str, int] = {}
        at = 96
        nodes = self.groups + self.datasets
        for node in nodes:
            self.vlen = []
            self.header_addr[node.name] = at
            at += sum(len(b) for b in self.header(node, at))
        for g in self.groups:
            ga = self.group_addr[g.name]
            ga[0] = self.header_addr[g.name]
            ga[1] = at
            at += self.btree_size()
            ga[2] = at
            at += 32 + len(self.heap_data(g)[0])
            if len(g._members):
                ga[3] = at
                at += self.snod_size()
        # the vlen strings, in the order the headers hold them
        self.vlen = []
        for node in nodes:
            self.messages(node)
        self.vlen_bytes = list(self.vlen)
        if self.vlen_bytes:
            self.gcol_addr = at
            at += self.gcol_size()
        for d in self.datasets:
            if d._data.nbytes:
                at = _pad8(at)
                self.data_addr[d.name] = at
                at += d._data.nbytes
        return at

    def gcol_size(self) -> int:
        used = 16 + sum(16 + _pad8(len(b)) for b in self.vlen_bytes)
        return max(GCOL_MIN, _pad8(used + 16))

    def write(self, path: str) -> None:
        end = self.layout()
        with open(path, "wb") as out:
            def put(addr, data):
                if out.tell() < addr:
                    out.write(b"\0" * (addr - out.tell()))
                if out.tell() != addr:
                    raise AssertionError("io/h5.py: layout overlap")
                out.write(data)

            root = self.group_addr["/"]
            sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", self.leaf_k, INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, UNDEF, end, UNDEF)
                  + struct.pack("<QQII", 0, root[0], 1, 0)
                  + struct.pack("<QQ", root[1], root[2]))
            put(0, sb)
            self.vlen = []
            for node in self.groups + self.datasets:
                at = self.header_addr[node.name]
                for block in self.header(node, at):
                    put(at, block)
                    at += len(block)
            for g in self.groups:
                self._write_group(put, g)
            if self.vlen_bytes:
                put(self.gcol_addr, self.gcol())
            for d in self.datasets:
                if d.name in self.data_addr:
                    put(self.data_addr[d.name],
                        d._data.reshape(-1).view(np.uint8))
            if out.tell() != end:
                raise AssertionError("io/h5.py: file size differs from its "
                                     "layout")

    def _write_group(self, put, g: Group) -> None:
        _, btree, heap, snod = self.group_addr[g.name]
        data, offsets = self.heap_data(g)
        names = list(g)
        node = (b"TREE" + bytes([0, 0]) + struct.pack("<H", 1 if names else 0)
                + struct.pack("<QQ", UNDEF, UNDEF) + struct.pack("<Q", 0))
        if names:
            node += struct.pack("<QQ", snod, offsets[names[-1]])
        put(btree, node + b"\0" * (self.btree_size() - len(node)))
        put(heap, b"HEAP" + bytes([0, 0, 0, 0])
            + struct.pack("<QQQ", len(data), FREE_NULL, heap + 32) + data)
        if not names:
            return
        sn = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names))
        for k in names:
            child = g._members[k]
            if isinstance(child, Group):
                ca = self.group_addr[child.name]
                sn += struct.pack("<QQII", offsets[k], ca[0], 1, 0)
                sn += struct.pack("<QQ", ca[1], ca[2])
            else:
                sn += struct.pack("<QQII", offsets[k],
                                  self.header_addr[child.name], 0, 0)
                sn += b"\0" * 16
        put(snod, sn + b"\0" * (self.snod_size() - len(sn)))

    def gcol(self) -> bytes:
        size = self.gcol_size()
        body = b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size)
        for i, b in enumerate(self.vlen_bytes, start=1):
            body += struct.pack("<HH4xQ", i, 0, len(b)) + _padded(b)
        free = size - len(body)
        body += struct.pack("<HH4xQ", 0, 0, free)
        return body + b"\0" * (size - len(body))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Reader:
    """Parses the superblock, every object header, the groups' B-trees,
    heaps and symbol-table nodes, and the attributes; datasets keep their
    address and are read when indexed."""

    def __init__(self, f: File):
        self.f = f
        self.fh = f._fh
        self.fh.seek(0, os.SEEK_END)
        self.size = self.fh.tell()
        self._gcols: dict[int, dict[int, bytes]] = {}

    def at(self, addr: int, n: int) -> bytes:
        if addr + n > self.size:
            raise OSError(f"{self.f.path}: truncated file (a read of {n} "
                          f"bytes at {addr} passes its end, {self.size})")
        self.fh.seek(addr)
        return self.fh.read(n)

    def read(self) -> None:
        base = None
        probe = 0
        while probe + 8 <= self.size:
            if self.at(probe, 8) == SIGNATURE:
                base = probe
                break
            probe = 512 if probe == 0 else 2 * probe
        if base is None:
            raise OSError(f"{self.f.path}: not an HDF5 file (no signature)")
        head = self.at(base, 24)
        version = head[8]
        if version not in (0, 1):
            raise OSError(f"{self.f.path}: superblock version {version} is "
                          "outside the subset")
        self.so, self.sl = head[13], head[14]
        if self.so != 8 or self.sl != 8:
            raise OSError(f"{self.f.path}: {self.so}-byte offsets are outside"
                          " the subset")
        p = base + 24 + (4 if version == 1 else 0)
        addrs = struct.unpack("<QQQQ", self.at(p, 32))
        self.base = addrs[0] if addrs[0] != UNDEF else base
        eof = addrs[2]
        if self.size < self.base + eof:
            raise OSError(f"{self.f.path}: truncated file: eof = {self.size},"
                          f" stored eof = {eof}")
        entry = self.at(p + 32, 40)
        root_header = struct.unpack_from("<Q", entry, 8)[0]
        self.load(self.f, self.header_messages(root_header))

    def addr(self, a: int) -> int:
        return self.base + a

    def header_messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        pre = self.at(self.addr(addr), 16)
        if pre[:4] == b"OHDR":
            raise OSError(f"{self.f.path}: version 2 object headers are "
                          "outside the subset")
        version, _, nmsgs, _, size = struct.unpack_from("<BBHII", pre)
        if version != 1:
            raise OSError(f"{self.f.path}: object header version {version}")
        blocks = [(self.addr(addr) + 16, size)]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            buf = self.at(start, length)
            q = 0
            while q + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, q)
                data = buf[q + 8:q + 8 + msize]
                q += 8 + msize
                if mtype == MSG_CONTINUATION:
                    caddr, clen = struct.unpack_from("<QQ", data)
                    blocks.append((self.addr(caddr), clen))
                elif mtype != MSG_NIL:
                    out.append((mtype, flags, data))
        return out

    def load(self, node: Node, msgs) -> None:
        """A node's attributes and, for a group, its members."""
        for mtype, flags, data in msgs:
            if mtype == MSG_ATTRIBUTE:
                name, value = self.attribute(data)
                dict.__setitem__(node.attrs, name, value)
            elif mtype == MSG_SYMBOL_TABLE and isinstance(node, Group):
                btree, heap = struct.unpack_from("<QQ", data)
                self.load_group(node, btree, heap)

    def dataset(self, parent: Group, name: str, msgs) -> Dataset:
        shape = tp = layout = None
        for mtype, flags, data in msgs:
            if mtype == MSG_DATASPACE:
                shape = _parse_dataspace(data, 0)
            elif mtype == MSG_DATATYPE:
                if flags & 0x02:
                    raise OSError(f"{self.f.path}: committed datatypes are "
                                  "outside the subset")
                tp, _ = _parse_type(data, 0)
            elif mtype == MSG_LAYOUT:
                layout = data
        if shape is None or tp is None or layout is None:
            raise OSError(f"{self.f.path}: {name} is neither a group nor a "
                          "dataset of the subset")
        if layout[0] != 3 or layout[1] not in (0, 1):
            raise OSError(f"{self.f.path}: {name}: layout version "
                          f"{layout[0]} class {layout[1]} (chunked or old "
                          "layouts are outside the subset)")
        if layout[1] == 1:
            where = struct.unpack_from("<Q", layout, 2)[0]
            if where != UNDEF:
                where = self.addr(where)
        else:
            n = struct.unpack_from("<H", layout, 2)[0]
            where = bytes(layout[4:4 + n])
        path = parent.name.rstrip("/") + "/" + name
        if tp.vlen:
            def post(a):
                return np.array([self.vlen_string(bytes(v)) for v in a],
                                dtype=object)

            return Dataset(self.f, path, shape, object, addr=where,
                           decode=(np.dtype("V16"), post))
        return Dataset(self.f, path, shape, tp.dtype, addr=where,
                       decode=(tp.raw, tp.post))

    def load_group(self, g: Group, btree: int, heap: int) -> None:
        hh = self.at(self.addr(heap), 32)
        if hh[:4] != b"HEAP":
            raise OSError(f"{self.f.path}: bad local heap signature")
        dsize, _, daddr = struct.unpack_from("<QQQ", hh, 8)
        names = self.at(self.addr(daddr), dsize)
        for off, header, cache in self.btree_entries(btree):
            end = names.index(b"\0", off)
            name = names[off:end].decode()
            msgs = self.header_messages(header)
            if any(m[0] == MSG_SYMBOL_TABLE for m in msgs):
                child = Group(self.f, g.name.rstrip("/") + "/" + name)
            else:
                child = self.dataset(g, name, msgs)
            g._members[name] = child
            self.load(child, msgs)

    def btree_entries(self, addr: int) -> list[tuple[int, int, int]]:
        """Every (name offset, header address, cache type) under the group
        B-tree node at addr, in key order, over any number of levels."""
        head = self.at(self.addr(addr), 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise OSError(f"{self.f.path}: bad group B-tree node")
        level = head[5]
        used = struct.unpack_from("<H", head, 6)[0]
        body = self.at(self.addr(addr) + 24, 8 + 16 * used)
        out = []
        for i in range(used):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level > 0:
                out.extend(self.btree_entries(child))
            else:
                out.extend(self.snod_entries(child))
        return out

    def snod_entries(self, addr: int) -> list[tuple[int, int, int]]:
        head = self.at(self.addr(addr), 8)
        if head[:4] != b"SNOD":
            raise OSError(f"{self.f.path}: bad symbol-table node")
        n = struct.unpack_from("<H", head, 6)[0]
        body = self.at(self.addr(addr) + 8, 40 * n)
        return [struct.unpack_from("<QQI", body, 40 * i) for i in range(n)]

    def vlen_string(self, elem: bytes) -> str:
        length, gaddr, index = struct.unpack("<IQI", elem)
        if length == 0 and gaddr in (0, UNDEF):
            return ""
        objs = self._gcols.get(gaddr)
        if objs is None:
            head = self.at(self.addr(gaddr), 16)
            if head[:4] != b"GCOL":
                raise OSError(f"{self.f.path}: bad global heap signature")
            size = struct.unpack_from("<Q", head, 8)[0]
            buf = self.at(self.addr(gaddr), size)
            objs = {}
            q = 16
            while q + 16 <= size:
                idx, _, osize = struct.unpack_from("<HH4xQ", buf, q)
                if idx == 0:
                    break
                objs[idx] = buf[q + 16:q + 16 + osize]
                q += 16 + _pad8(osize)
            self._gcols[gaddr] = objs
        return objs[index][:length].decode("utf-8")

    def attribute(self, data: bytes):
        version = data[0]
        nlen, tlen, slen = struct.unpack_from("<HHH", data, 2)
        if version == 1:
            q = 8
            name = data[q:q + nlen - 1].decode()
            q += _pad8(nlen)
            tp, _ = _parse_type(data, q)
            q += _pad8(tlen)
            shape = _parse_dataspace(data, q)
            q += _pad8(slen)
        elif version in (2, 3):
            q = 8 if version == 2 else 9
            name = data[q:q + nlen - 1].decode()
            q += nlen
            tp, _ = _parse_type(data, q)
            q += tlen
            shape = _parse_dataspace(data, q)
            q += slen
        else:
            raise OSError(f"{self.f.path}: attribute message version "
                          f"{version}")
        if shape is None:  # null dataspace: h5py gives an Empty
            return name, None
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if tp.vlen:
            vals = [self.vlen_string(data[q + 16 * i:q + 16 * (i + 1)])
                    for i in range(n)]
            if not shape:
                return name, vals[0]
            return name, np.array(vals, dtype=object).reshape(shape)
        a = tp.post(np.frombuffer(data, dtype=tp.raw, count=n,
                                  offset=q).copy())
        return name, (a[0] if not shape else a.reshape(shape))
