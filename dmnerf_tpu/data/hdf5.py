"""Minimal HDF5 I/O for the datasets' palette file (``ins_rgb.hdf5``).

DM-SR, Replica and ScanNet ship their instance palette as an HDF5 file holding one
small array under the key ``datasets`` (reference datasets/loader_*.py read it with
h5py). This module reads and writes exactly that kind of file with numpy alone, so
the train and test paths need no HDF5 library:

  * superblock version 0 or 1 (what h5py writes by default), 8-byte offsets and
    lengths, little-endian;
  * the root group as a symbol table (version-1 B-tree + local heap + symbol
    table nodes), version-1 object headers, with continuation blocks;
  * datasets with contiguous or compact layout (layout message version 3), no
    filters, of a fixed-point or IEEE floating-point type.

Anything outside that subset raises ValueError naming the feature; a file that is
not HDF5 at all raises too. ``write_dataset`` writes the same layout h5py writes
for one small contiguous dataset (tests/test_hdf5.py reads each side's files with
the other).
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16

# object header message types
_MSG_NIL, _MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL = 0x00, 0x01, 0x03, 0x05
_MSG_LAYOUT, _MSG_FILTERS, _MSG_CONT, _MSG_SYMTAB = 0x08, 0x0B, 0x10, 0x11


def _u(buf: bytes, off: int, n: int) -> int:
    return int.from_bytes(buf[off:off + n], "little")


def _messages(buf: bytes, addr: int):
    """Yield (type, data) of every message of the version-1 object header at addr."""
    if buf[addr] != 1:
        raise ValueError(f"hdf5: object header version {buf[addr]} is not supported "
                         f"(only version 1)")
    n_msgs, size = _u(buf, addr + 2, 2), _u(buf, addr + 8, 4)
    blocks = [(addr + 16, size)]
    seen = 0
    while blocks and seen < n_msgs:
        start, length = blocks.pop(0)
        off = start
        while off + 8 <= start + length and seen < n_msgs:
            mtype, msize = _u(buf, off, 2), _u(buf, off + 2, 2)
            data = buf[off + 8:off + 8 + msize]
            seen += 1
            if mtype == _MSG_CONT:
                blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
            elif mtype != _MSG_NIL:
                yield mtype, data
            off += 8 + msize


def _group_entries(buf: bytes, btree: int, heap: int) -> dict:
    """name -> object header address, for a symbol-table group."""
    if buf[heap:heap + 4] != b"HEAP":
        raise ValueError("hdf5: bad local heap signature")
    heap_data = _u(buf, heap + 24, 8)
    out = {}

    def walk(node: int) -> None:
        if buf[node:node + 4] != b"TREE" or buf[node + 4] != 0:
            raise ValueError("hdf5: bad group B-tree node")
        level, used = buf[node + 5], _u(buf, node + 6, 2)
        for i in range(used):
            child = _u(buf, node + 24 + 8 + 16 * i, 8)
            if level > 0:
                walk(child)
                continue
            if buf[child:child + 4] != b"SNOD":
                raise ValueError("hdf5: bad symbol table node")
            for j in range(_u(buf, child + 6, 2)):
                e = child + 8 + 40 * j
                name_off = heap_data + _u(buf, e, 8)
                name = buf[name_off:buf.index(b"\0", name_off)].decode()
                out[name] = _u(buf, e + 8, 8)

    walk(btree)
    return out


def _dtype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = data[1], _u(data, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        kind = "i" if bits & 0x08 else "u"
    elif cls == 1:
        kind = "f"
    else:
        raise ValueError(f"hdf5: datatype class {cls} (version {version}) is not supported "
                         f"(only fixed-point and floating-point)")
    return np.dtype(f"{order}{kind}{size}")


def _shape(data: bytes) -> tuple:
    version, ndim = data[0], data[1]
    start = {1: 8, 2: 4}.get(version)
    if start is None:
        raise ValueError(f"hdf5: dataspace message version {version} is not supported")
    return tuple(_u(data, start + 8 * i, 8) for i in range(ndim))


def read_dataset(path: str, name: str = "datasets") -> np.ndarray:
    """Read the array stored under ``name`` in the root group of an HDF5 file."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"hdf5: {path} is not an HDF5 file (no signature at offset 0)")
    version = buf[8]
    if version not in (0, 1):
        raise ValueError(f"hdf5: {path} has superblock version {version}; only versions "
                         f"0 and 1 are supported")
    if buf[13] != 8 or buf[14] != 8:
        raise ValueError(f"hdf5: {path} uses {buf[13]}-byte offsets / {buf[14]}-byte "
                         f"lengths; only 8 is supported")
    root_entry = 24 + (4 if version == 1 else 0) + 32
    root = _u(buf, root_entry + 8, 8)
    symtab = dict(_messages(buf, root)).get(_MSG_SYMTAB)
    if symtab is None:
        raise ValueError(f"hdf5: {path}: root group has no symbol table (new-style "
                         f"link storage is not supported)")
    entries = _group_entries(buf, _u(symtab, 0, 8), _u(symtab, 8, 8))
    if name not in entries:
        raise KeyError(f"hdf5: {path} has no dataset {name!r} (has {sorted(entries)})")
    msgs = dict(_messages(buf, entries[name]))
    if _MSG_FILTERS in msgs:
        raise ValueError(f"hdf5: {path}:{name} is filtered/compressed; not supported")
    if _MSG_DATASPACE not in msgs or _MSG_DATATYPE not in msgs or _MSG_LAYOUT not in msgs:
        raise ValueError(f"hdf5: {path}:{name} is not a dataset")
    shape, dtype = _shape(msgs[_MSG_DATASPACE]), _dtype(msgs[_MSG_DATATYPE])
    layout = msgs[_MSG_LAYOUT]
    if layout[0] != 3:
        raise ValueError(f"hdf5: layout message version {layout[0]} is not supported")
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if layout[1] == 0:      # compact: the raw data sits in the message
        raw = layout[4:4 + _u(layout, 2, 2)]
    elif layout[1] == 1:    # contiguous
        addr = _u(layout, 2, 8)
        raw = b"\0" * nbytes if addr == _UNDEF else buf[addr:addr + nbytes]
    else:
        raise ValueError(f"hdf5: {path}:{name} uses chunked storage; not supported")
    if len(raw) != nbytes:
        raise ValueError(f"hdf5: {path}:{name} is truncated")
    return np.frombuffer(raw, dtype).reshape(shape).astype(dtype.newbyteorder("="))


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(msgs: bytes, n_msgs: int) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, n_msgs, 1, len(msgs)) + msgs


def write_dataset(path: str, array, name: str = "datasets") -> None:
    """Write one integer array as the only dataset of a new HDF5 file."""
    a = np.ascontiguousarray(array)
    if a.dtype.kind not in "iu":
        raise ValueError(f"hdf5: write_dataset supports integer arrays, got {a.dtype}")
    a = a.astype(a.dtype.newbyteorder("<"))
    key = name.encode() + b"\0"

    sb_size, root_at = 96, 96
    root_size = 16 + 8 + 16
    btree_at = root_at + root_size
    btree_size = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
    heap_at = btree_at + btree_size
    heap_data_at = heap_at + 32
    names = b"\0" * 8 + _pad8(key)           # offset 0: the root's empty name
    free_at, free_size = len(names), 64
    heap_size = len(names) + free_size
    snod_at = heap_data_at + heap_size
    snod_size = 8 + 2 * _LEAF_K * 40
    dset_at = snod_at + snod_size

    ndim = a.ndim
    dataspace = struct.pack("<BBB5x", 1, ndim, 1) + struct.pack(f"<{2 * ndim}Q", *a.shape,
                                                                  *a.shape)
    bits = 0x08 if a.dtype.kind == "i" else 0
    datatype = struct.pack("<BBBBIHH", 0x10, bits, 0, 0, a.dtype.itemsize, 0,
                           8 * a.dtype.itemsize)
    fill = bytes([2, 2, 2, 1, 0, 0, 0, 0])
    n_dset_msgs = 4
    dset_size = 16 + sum(8 + len(_pad8(m)) for m in (dataspace, datatype, fill)) + 8 + 24
    data_at = dset_at + dset_size
    data_at += -data_at % 8
    layout = struct.pack("<BBQQ", 3, 1, data_at, a.nbytes)
    dset = _object_header(
        _message(_MSG_DATASPACE, dataspace) + _message(_MSG_DATATYPE, datatype, 1)
        + _message(_MSG_FILL, fill, 1) + _message(_MSG_LAYOUT, layout), n_dset_msgs)
    assert len(dset) == dset_size
    eof = data_at + a.nbytes

    sb = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
          + struct.pack("<4Q", 0, _UNDEF, eof, _UNDEF)
          + struct.pack("<QQI4xQQ", 0, root_at, 1, btree_at, heap_at))
    root = _object_header(_message(_MSG_SYMTAB, struct.pack("<QQ", btree_at, heap_at)), 1)
    btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
             + struct.pack("<QQQ", 0, snod_at, 8))
    heap = b"HEAP" + struct.pack("<B3xQQQ", 0, heap_size, free_at, heap_data_at)
    heap_data = names + struct.pack("<QQ", 1, free_size)   # free block; 1 = end of list
    snod = b"SNOD" + struct.pack("<BxH", 1, 1) + struct.pack("<QQI4x16x", 8, dset_at, 0)

    out = bytearray(eof)
    for at, blob in ((0, sb), (root_at, root), (btree_at, btree), (heap_at, heap),
                     (heap_data_at, heap_data), (snod_at, snod), (dset_at, dset),
                     (data_at, a.tobytes())):
        out[at:at + len(blob)] = blob
    assert len(sb) == sb_size and len(root) == root_size and len(out) == eof
    with open(path, "wb") as f:
        f.write(bytes(out))
