"""TensorBoard metrics writer, with no tensorboardX or tensorboard import.

Counterpart of `brax_tpu/io/metrics.py`: the `Writer` context manager with
`write_hparams` and `write_scalars`.  The JAX package writes through
tensorboardX; the port writes the event file itself, one way everywhere (the
card's machine has neither package):

- an event file `events.out.tfevents.<seconds>.<host>` in the logdir, of
  TFRecord frames (little-endian uint64 length, masked CRC-32C of the
  length, the data, masked CRC-32C of the data);
- its first record an `Event` with `file_version` "brain.Event:2", then one
  `Event` per scalar: `wall_time`, `step` and a `Summary` of one value
  (`tag`, `simple_value`, a float32), the protobuf encoded by hand below.
  The scalars decode to the (tag, step, value) records that the JAX
  `Writer` writes.

Divergence: `write_hparams` writes `hparams.json` in the logdir, where the
JAX `Writer` writes the hparams plugin's summaries into a subdirectory.

`read_events` and `read_scalars` decode such a file (CRCs checked), so that
a run's scalars can be read back where tensorboardX is missing.
"""

from __future__ import annotations

import json
import os
import re
import socket
import struct
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # an int64 as protobuf's two's complement
    out = bytearray()
    while True:
        bits, n = n & 0x7F, n >> 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 scalar: Optional[Tuple[str, float]] = None) -> bytes:
    """An `Event` protobuf: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5, Summary); a Summary value is
    tag (1, string) and simple_value (2, float)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        value_msg = _bytes_field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
        out += _bytes_field(5, _bytes_field(1, value_msg))
    return out


def frame(data: bytes) -> bytes:
    """One TFRecord frame around `data`."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class Writer:
    """Context-managed TensorBoard event-file writer."""

    def __init__(self, logdir: Optional[str] = None):
        if logdir is None:
            logdir = os.path.join("runs", datetime.now().strftime("%b%d_%H-%M-%S") + "_"
                                  + socket.gethostname())
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}.{socket.gethostname()}")
        self._file = open(self.path, "wb")
        self._file.write(frame(encode_event(time.time(), file_version="brain.Event:2")))
        self._file.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def close(self):
        self._file.close()

    def write_hparams(self, hparams: Dict[str, float]):
        """Writes `hparams` to `hparams.json` in the logdir."""
        with open(os.path.join(self.logdir, "hparams.json"), "w") as f:
            json.dump(dict(hparams), f, sort_keys=True)

    def write_scalars(self, step: int, scalars: Dict[str, float]):
        for key, value in scalars.items():
            tag = _INVALID_TAG_CHARACTERS.sub("_", key).lstrip("/")
            self._file.write(frame(encode_event(time.time(), int(step),
                                                scalar=(tag, float(value)))))
        self._file.flush()


# ---------------------------------------------------------------------------
# reading back
# ---------------------------------------------------------------------------


def records(path: str) -> List[bytes]:
    """The data of every TFRecord frame of a file; raises on a bad CRC."""
    with open(path, "rb") as f:
        raw = f.read()
    out, at = [], 0
    while at < len(raw):
        length_bytes = raw[at:at + 8]
        (length,) = struct.unpack("<Q", length_bytes)
        (length_crc,) = struct.unpack("<I", raw[at + 8:at + 12])
        data = raw[at + 12:at + 12 + length]
        (data_crc,) = struct.unpack("<I", raw[at + 12 + length:at + 16 + length])
        if masked_crc32c(length_bytes) != length_crc or masked_crc32c(data) != data_crc:
            raise ValueError(f"{path}: bad CRC in the record at byte {at}")
        out.append(data)
        at += 16 + length
    return out


def _read_varint(buf: bytes, at: int) -> Tuple[int, int]:
    n, shift = 0, 0
    while True:
        b = buf[at]
        n |= (b & 0x7F) << shift
        at, shift = at + 1, shift + 7
        if not b & 0x80:
            return n, at


def _fields(buf: bytes):
    """(number, wire type, value) of each field of a protobuf message."""
    at = 0
    while at < len(buf):
        key, at = _read_varint(buf, at)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, at = _read_varint(buf, at)
        elif wire == 1:
            value, at = buf[at:at + 8], at + 8
        elif wire == 2:
            length, at = _read_varint(buf, at)
            value, at = buf[at:at + length], at + length
        elif wire == 5:
            value, at = buf[at:at + 4], at + 4
        else:
            raise ValueError(f"wire type {wire} is not read")
        yield number, wire, value


def decode_event(data: bytes) -> dict:
    """wall_time, step, file_version and the summary's (tag, simple_value)
    pairs of an `Event`."""
    event = {"wall_time": 0.0, "step": 0, "file_version": None, "values": []}
    for number, _, value in _fields(data):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value - (1 << 64) if value >= 1 << 63 else value
        elif number == 3:
            event["file_version"] = value.decode()
        elif number == 5:
            for v_number, _, v in _fields(value):
                if v_number != 1:
                    continue
                tag, simple = None, None
                for f_number, _, f in _fields(v):
                    if f_number == 1:
                        tag = f.decode()
                    elif f_number == 2:
                        simple = struct.unpack("<f", f)[0]
                event["values"].append((tag, simple))
    return event


def read_events(path: str) -> List[dict]:
    """Every `Event` of an event file, decoded (decode_event)."""
    return [decode_event(r) for r in records(path)]


def read_scalars(path: str) -> List[Tuple[str, int, float]]:
    """(tag, step, value) of every scalar of an event file."""
    return [(tag, e["step"], value) for e in read_events(path) for tag, value in e["values"]]
