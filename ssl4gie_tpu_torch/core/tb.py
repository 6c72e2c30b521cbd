"""Minimal TensorBoard event-file writer, no TensorFlow dependency (port of
`ssl4gie_tpu/core/tb.py`, standard library only).

The reference logs scalars through `torch.utils.tensorboard.SummaryWriter`
(`Models/mae/engine_pretrain.py:70-76`, `Models/mae/main_pretrain.py:237-239`,
`Models/moco_v3/main_moco.py:233`). This writes the same
`events.out.tfevents.*` file directly: TFRecord framing (length +
masked crc32c) around hand-encoded `Event{wall_time, step,
summary{value{tag, simple_value}}}` protobufs, the scalar subset that
TensorBoard reads.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c
# Castagnoli CRC (poly 0x82F63B78, reflected), the TFRecord checksum.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf
# Wire-format helpers for the three messages we emit (event.proto /
# summary.proto field numbers).

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tagged_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)     # wall_time
    if step:
        out += _varint(2 << 3 | 0) + _varint(step)               # step
    return out + body


def _scalar_summary(tag: str, value: float) -> bytes:
    val = (_tagged_bytes(1, tag.encode("utf-8"))                 # Value.tag
           + _varint(2 << 3 | 5) + struct.pack("<f", value))     # simple_value
    return _tagged_bytes(5, _tagged_bytes(1, val))               # Event.summary


class SummaryWriter:
    """Scalar-only `SummaryWriter` work-alike producing real tfevents files."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.v2")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        # file header: Event{file_version: "brain.Event:2"}
        self._write(_event(time.time(), 0,
                           _tagged_bytes(3, b"brain.Event:2")))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + record + struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step),
                           _scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str):
    """Decode scalars back from a tfevents file (tests / offline inspection).
    Returns a list of (step, tag, value); validates both record CRCs."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (crc_h,) = struct.unpack("<I", f.read(4))
            assert crc_h == _masked_crc(header), "corrupt length crc"
            (n,) = struct.unpack("<Q", header)
            rec = f.read(n)
            (crc_d,) = struct.unpack("<I", f.read(4))
            assert crc_d == _masked_crc(rec), "corrupt data crc"
            out.extend(_decode_event(rec))


def _decode_event(rec: bytes):
    step, summary = 0, b""
    i = 0
    while i < len(rec):
        key = rec[i]
        i += 1
        field, wire = key >> 3, key & 7
        if wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            v = 0
            shift = 0
            while True:
                b = rec[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if field == 2:
                step = v
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = rec[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if field == 5:
                summary = rec[i:i + ln]
            i += ln
    out = []
    i = 0
    while i < len(summary):                      # repeated Summary.value
        assert summary[i] == (1 << 3 | 2)
        i += 1
        ln = summary[i]
        i += 1
        val = summary[i:i + ln]
        i += ln
        j = 0
        tag, value = "", 0.0
        while j < len(val):
            key = val[j]
            j += 1
            if key == (1 << 3 | 2):
                vlen = val[j]
                j += 1
                tag = val[j:j + vlen].decode("utf-8")
                j += vlen
            elif key == (2 << 3 | 5):
                (value,) = struct.unpack("<f", val[j:j + 4])
                j += 4
            else:
                raise AssertionError(f"unexpected key {key}")
        out.append((step, tag, value))
    return out
