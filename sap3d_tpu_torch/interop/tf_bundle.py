"""Read a TensorFlow checkpoint (tensor bundle, V2) with numpy alone.

The reference's trained weights are ``tf.compat.v1.train.Saver``
checkpoints; the GPU host has neither TensorFlow nor protobuf, so this
module reads the format itself.  ``read_checkpoint(path)`` returns what
``tf.train.load_checkpoint(path)`` lists through
``get_variable_to_shape_map`` and ``get_tensor``: every name, with its
dtype, shape and value.

A checkpoint with prefix ``P`` is ``P.index`` and the shards
``P.data-{i:05d}-of-{n:05d}``:

* ``P.index`` is a LevelDB-format table.  Its last 48 bytes are the footer:
  the metaindex and index block handles (each a varint64 offset and size),
  zero padding, then the magic ``0xdb4775248b80fb57`` as a little-endian
  uint64.  Each block is followed by a 5-byte trailer (the compression
  byte, 0 = none, then a masked crc32c).  A block holds entries (shared
  key prefix length, unshared length and value length as varint32, the key
  suffix, the value), then the restart offsets (uint32 each) and their
  count (uint32).  The index block's values are the data blocks' handles.
* Key ``""`` holds a ``BundleHeaderProto`` (1 ``num_shards``, 2
  endianness, 3 version); every other key a tensor's ``BundleEntryProto``
  (1 dtype, 2 ``TensorShapeProto`` whose repeated field 2 is a dim with
  field 1 ``size``, 3 ``shard_id``, 4 ``offset``, 5 ``size``, 6 fixed32
  ``crc32c``, 7 ``slices``), parsed here from the wire format by hand.
* A tensor is ``size`` bytes at ``offset`` of its shard: the little-endian
  elements, or for strings each element's varint64 length, a 4-byte masked
  crc32c of the lengths, then the bytes of every element.

The tensors' crc32c is not recomputed here (TensorFlow's reader checks it).
Partitioned variables (``slices``), big-endian bundles, compressed blocks
and dtypes outside ``DTYPES`` raise.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5

# TensorFlow DataType enum -> numpy dtype (little-endian); 7 is DT_STRING
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 4: np.dtype("u1"),
          5: np.dtype("<i2"), 6: np.dtype("i1"), 9: np.dtype("<i8"), 10: np.dtype("?"),
          19: np.dtype("<f2")}
DT_STRING = 7


class CheckpointFormatError(ValueError):
    """The file is not a tensor bundle this reader takes."""


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise CheckpointFormatError("truncated or overlong varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> list[tuple[int, object]]:
    """(field number, value) of every field of a serialized message: an int
    for varint and fixed types, bytes for length-delimited ones.  Unknown
    fields are kept and the caller ignores them."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise CheckpointFormatError(f"unsupported protobuf wire type {wire}")
        if pos > len(buf):
            raise CheckpointFormatError("truncated protobuf message")
        out.append((field, value))
    return out


def _block(index: bytes, offset: int, size: int) -> bytes:
    """The contents of the block at (offset, size), its trailer checked."""
    end = offset + size
    if end + BLOCK_TRAILER_BYTES > len(index):
        raise CheckpointFormatError(f"block ({offset}, {size}) runs past the file")
    if index[end] != 0:
        raise CheckpointFormatError(f"compressed block (type {index[end]}) is not supported")
    return index[offset:end]


def _block_entries(block: bytes) -> list[tuple[bytes, bytes]]:
    """(key, value) of every entry of a table block, in order."""
    if len(block) < 4:
        raise CheckpointFormatError("block shorter than its restart count")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 - 4 * n_restarts
    if limit < 0:
        raise CheckpointFormatError("block's restart array runs past the block")
    out, pos, key = [], 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > limit:
            raise CheckpointFormatError("corrupt block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        out.append((key, block[pos:pos + n_value]))
        pos += n_value
    return out


def _handle(buf: bytes, pos: int = 0) -> tuple[tuple[int, int], int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _table(index: bytes, path: str) -> list[tuple[bytes, bytes]]:
    """Every (key, value) of the table ``index`` (the bytes of ``path``)."""
    if len(index) < FOOTER_BYTES:
        raise CheckpointFormatError(f"{path}: shorter than a table footer")
    footer = index[-FOOTER_BYTES:]
    magic = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0]
    if magic != TABLE_MAGIC:
        raise CheckpointFormatError(f"{path}: bad table magic {magic:#018x}")
    _, pos = _handle(footer)  # the metaindex block: no filters in a bundle
    index_handle, _ = _handle(footer, pos)
    entries = []
    for _, value in _block_entries(_block(index, *index_handle)):
        entries += _block_entries(_block(index, *_handle(value)[0]))
    return entries


def _header(value: bytes, path: str) -> int:
    """``num_shards`` of the bundle header; big-endian bundles raise."""
    num_shards, endianness = 1, 0
    for field, v in _fields(value):
        if field == 1:
            num_shards = v
        elif field == 2:
            endianness = v
    if endianness != 0:
        raise CheckpointFormatError(f"{path}: big-endian bundles are not supported")
    return num_shards


def _shape(value: bytes) -> tuple[int, ...]:
    dims = []
    for field, dim in _fields(value):
        if field == 2:
            size = [v for f, v in _fields(dim) if f == 1]
            dims.append(size[-1] if size else 0)
    return tuple(dims)


def _entry(name: str, value: bytes) -> dict:
    entry = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0)
    for field, v in _fields(value):
        if field == 1:
            entry["dtype"] = v
        elif field == 2:
            entry["shape"] = _shape(v)
        elif field == 3:
            entry["shard_id"] = v
        elif field == 4:
            entry["offset"] = v
        elif field == 5:
            entry["size"] = v
        elif field == 7:
            raise CheckpointFormatError(f"{name}: partitioned variables (slices) are not "
                                        "supported")
    return entry


def _strings(raw: bytes, count: int, name: str) -> list[bytes]:
    lengths, pos = [], 0
    for _ in range(count):
        n, pos = _varint(raw, pos)
        lengths.append(n)
    pos += 4  # masked crc32c of the lengths
    out = []
    for n in lengths:
        out.append(bytes(raw[pos:pos + n]))
        pos += n
    if pos != len(raw):
        raise CheckpointFormatError(f"{name}: string tensor holds {len(raw)} bytes, its "
                                    f"elements {pos}")
    return out


def _decode(name: str, entry: dict, raw: bytearray) -> np.ndarray:
    shape, dtype = entry["shape"], entry["dtype"]
    count = int(np.prod(shape, dtype=np.int64))
    if dtype == DT_STRING:
        arr = np.empty(count, dtype=object)
        arr[:] = _strings(raw, count, name)
        return arr.reshape(shape)
    if dtype not in DTYPES:
        raise CheckpointFormatError(f"{name}: TensorFlow dtype {dtype} is not supported")
    np_dtype = DTYPES[dtype]
    if len(raw) != np_dtype.itemsize * count:
        raise CheckpointFormatError(f"{name}: {len(raw)} bytes for {count} elements of "
                                    f"{np_dtype}")
    return np.frombuffer(raw, np_dtype).reshape(shape)


def _unescape(text: str) -> str:
    """A text-format string literal's escapes (``\\"``, ``\\\\``, ``\\n``,
    octal ``\\NNN``) undone."""
    simple = {"n": "\n", "r": "\r", "t": "\t", '"': '"', "'": "'", "\\": "\\"}
    raw = re.sub(r"\\([0-7]{3}|.)", lambda m: chr(int(m.group(1), 8))
                 if len(m.group(1)) == 3 else simple.get(m.group(1), m.group(1)), text)
    return raw.encode("latin-1").decode("utf-8")


def _checkpoint_prefix(path: str) -> str:
    """The bundle prefix ``path`` names: a directory's ``checkpoint`` file's
    ``model_checkpoint_path`` (resolved against the directory), or ``path``
    itself where ``<path>.index`` exists; anything else raises."""
    path = os.fspath(path)
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.isfile(state):
            raise FileNotFoundError(f"{path}: a directory without a 'checkpoint' file")
        with open(state, encoding="latin-1") as f:  # bytes; _unescape decodes UTF-8
            m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(), re.M)
        if m is None:
            raise CheckpointFormatError(f"{state}: no model_checkpoint_path")
        path = os.path.join(path, _unescape(m.group(1)))
    if not os.path.isfile(path + ".index"):
        raise FileNotFoundError(f"no TensorFlow V2 checkpoint at {path} ({path}.index is "
                                "missing; V1 single-file checkpoints are not supported)")
    return path


def read_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every tensor of the TF checkpoint at ``path`` (a directory or a
    prefix), by name: numeric tensors as numpy arrays of their dtype and
    shape, string tensors as object arrays of ``bytes``."""
    prefix = _checkpoint_prefix(path)
    with open(prefix + ".index", "rb") as f:
        index = f.read()
    entries = _table(index, prefix + ".index")
    if not entries or entries[0][0] != b"":
        raise CheckpointFormatError(f"{prefix}.index: no bundle header")
    num_shards = _header(entries[0][1], prefix + ".index")
    tensors = {key.decode("utf-8"): _entry(key.decode("utf-8"), value)
               for key, value in entries[1:]}
    out: dict[str, np.ndarray] = {}
    for shard in sorted({e["shard_id"] for e in tensors.values()}):
        data = f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"
        with open(data, "rb") as f:
            for name, entry in tensors.items():
                if entry["shard_id"] != shard:
                    continue
                f.seek(entry["offset"])
                raw = bytearray(entry["size"])
                if f.readinto(raw) != entry["size"]:
                    raise CheckpointFormatError(f"{name}: {data} ends before its bytes")
                out[name] = _decode(name, entry, raw)
    return {name: out[name] for name in tensors}
