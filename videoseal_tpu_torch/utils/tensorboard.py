"""Minimal TensorBoard event writer, counterpart of ``videoseal_tpu/utils/tensorboard.py``.

Needs no tensorboard package: scalars are written in the TB event-file
format directly (the record framing and a Summary protobuf encoded by hand
with struct and zlib, scalars only).
"""

from __future__ import annotations

import os
import struct
import time
import zlib


def _crc32c(data: bytes) -> int:
    # TFRecord uses masked crc32c; zlib.crc32 is crc32 (different poly), but
    # TensorBoard's reader does not verify the CRC, so crc32 suffices here.
    crc = zlib.crc32(data) & 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _scalar_summary(tag: str, value: float, step: int, wall: float) -> bytes:
    # Summary { value { tag: tag  simple_value: value } } inside Event
    tag_b = tag.encode()
    sv = struct.pack("<f", value)
    value_msg = (b"\x0a" + _varint(len(tag_b)) + tag_b  # field 1 tag
                 + b"\x15" + sv)                         # field 2 simple_value
    summary = b"\x0a" + _varint(len(value_msg)) + value_msg
    event = (b"\x09" + struct.pack("<d", wall)          # field 1 wall_time
             + b"\x10" + _varint(step)                   # field 2 step
             + b"\x2a" + _varint(len(summary)) + summary)  # field 5 summary
    return event


class TensorboardWriter:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._f = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"events.out.tfevents.{int(time.time())}.videoseal_tpu_torch")
            self._f = open(path, "ab")

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _crc32c(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        if self._f is None:
            return
        self._write_record(_scalar_summary(tag, float(value), int(step), time.time()))

    def add_scalars(self, prefix: str, values: dict, step: int):
        for k, v in values.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._f:
            self._f.close()
