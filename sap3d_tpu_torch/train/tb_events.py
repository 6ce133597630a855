"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

A copy of ``sap3d_tpu/train/tb_events.py``.  The trainer writes scalar
events beside ``metrics.jsonl`` as real ``events.out.tfevents.*`` files that
TensorBoard reads.

File format (TFRecord framing):
    [ length:uint64 | masked_crc32c(length):uint32 |
      data:length bytes | masked_crc32c(data):uint32 ]
where ``data`` is a serialized ``tensorflow.Event`` proto.  The two protos
needed for scalars are tiny, so they are hand-encoded here:

    Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
    Summary { repeated Value value = 1; }
    Summary.Value { string tag = 1; float simple_value = 2; }
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE: list[int] = []


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TFRecord framing uses."""
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    tag_b = tag.encode()
    val = (
        _tag(1, 2) + _varint(len(tag_b)) + tag_b       # Value.tag
        + _tag(2, 5) + struct.pack("<f", value)        # Value.simple_value
    )
    summary = _tag(1, 2) + _varint(len(val)) + val     # Summary.value
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)      # Event.wall_time
        + _tag(2, 0) + _varint(step & (2**64 - 1))     # Event.step (int64)
        + _tag(5, 2) + _varint(len(summary)) + summary  # Event.summary
    )


def _file_version_event(wall_time: float) -> bytes:
    ver = b"brain.Event:2"
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)
        + _tag(3, 2) + _varint(len(ver)) + ver          # Event.file_version
    )


class EventWriter:
    """Append-only scalar event writer, one file per run directory.

    Usage::

        w = EventWriter(logs_dir)
        w.scalar("total_loss", loss, step)
        w.flush(); w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        t = time.time()
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(t)}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event(t))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + data
            + struct.pack("<I", _masked_crc(data))
        )

    def scalar(
        self, tag: str, value: float, step: int, wall_time: float | None = None
    ) -> None:
        self._write_record(
            _scalar_event(tag, float(value), int(step),
                          time.time() if wall_time is None else wall_time)
        )

    def scalars(self, values: dict, step: int) -> None:
        """Write every numeric entry of ``values`` as its own scalar.
        ``numbers.Number`` covers numpy scalars (np.float32 etc.), which a
        plain (int, float) isinstance would silently drop."""
        import numbers

        t = time.time()
        for key, v in values.items():
            if key == "step":
                continue
            if isinstance(v, numbers.Number) and not isinstance(v, bool):
                self.scalar(key, v, step, t)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
