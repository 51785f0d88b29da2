"""Copy of avcer_tpu/utils/tb.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Minimal TensorBoard event writer (scalars), dependency-free.

The reference logs per-phase scalars through tensorboardX
(the reference's src/audio/net_trainer/net_trainer.py:11, 185-187, 230-235).
tensorboardX is not in this image, so this module hand-encodes the two
protobufs involved (Event / Summary, proto3 wire format) and the TFRecord
framing (length + masked crc32c) — enough for ``tensorboard --logdir`` to
render scalar curves.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def scalar_event(tag: str, value: float, step: int, wall_time: Optional[float] = None) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    sval = _len_delim(1, tag.encode()) + _float(2, float(value))
    summary = _len_delim(1, sval)  # Summary { value = 1 repeated }
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return (
        _double(1, wall_time if wall_time is not None else time.time())
        + _int64(2, int(step))
        + _len_delim(5, summary)
    )


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Drop-in subset of tensorboardX.SummaryWriter (add_scalar/flush/close)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.avcer"
        self._fh = open(os.path.join(log_dir, fname), "ab")
        # file-version event
        ver = _double(1, time.time()) + _len_delim(3, b"brain.Event:2")
        self._fh.write(_record(ver))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._fh.write(_record(scalar_event(tag, value, global_step)))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
