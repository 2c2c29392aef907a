"""TensorBoard-compatible event writer (pure Python, zero deps).

The reference logs scalars through two `tf.summary.FileWriter`s per model
(`TLSAN/model.py:17-19`) — train summaries at display_freq and eval
AUC/P@k/R@k as manual `tf.Summary` values (`TLSAN/train.py:91-94,103-117`).
This module reproduces the on-disk contract: `events.out.tfevents.*` files in
TFRecord framing (length + masked-CRC32C + payload + masked-CRC32C) holding
hand-encoded `Event{wall_time, step, summary{value{tag, simple_value}}}`
protos, readable by stock TensorBoard.  No TF import — the proto encoding is
~40 lines of varint/fixed-width packing.

A copy of tlsan_tpu/train/tensorboard.py (pure Python, struct and crc32c).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding for Event / Summary / Summary.Value
# ---------------------------------------------------------------------------


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
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_value(tag_name: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return (_len_delimited(1, tag_name.encode("utf-8"))
            + _tag(2, 5) + struct.pack("<f", value))


def encode_scalar_event(step: int, wall_time: float,
                        scalars: Dict[str, float]) -> bytes:
    """Event{wall_time=1(double), step=2(int64), summary=5{value=1...}}."""
    summary = b"".join(
        _len_delimited(1, _encode_value(k, float(v)))
        for k, v in scalars.items())
    ev = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        ev += _tag(2, 0) + _varint(step)
    ev += _len_delimited(5, summary)
    return ev


_BUCKET_LIMITS = None


def tf_bucket_limits():
    """TF's default histogram bucket grid (histogram.cc): ±1e-12 · 1.1^k,
    ascending, with a huge final catch-all edge.  Zero lands in the
    (-1e-12, 1e-12] bucket."""
    global _BUCKET_LIMITS
    if _BUCKET_LIMITS is None:
        import numpy as np
        pos = []
        v = 1e-12
        while v < 1e20:
            pos.append(v)
            v *= 1.1
        pos.append(1.7976931348623157e308)
        _BUCKET_LIMITS = np.asarray(
            [-x for x in reversed(pos)] + pos, dtype=np.float64)
    return _BUCKET_LIMITS


def histo_digest_np(arr):
    """(min, max, num, sum, sum_squares, counts) over tf_bucket_limits —
    the host-side reference for the device-side digest in train/loop.py."""
    import numpy as np
    a = np.asarray(arr, dtype=np.float64).reshape(-1)
    limits = tf_bucket_limits()
    # bucket i holds values in (limits[i-1], limits[i]]
    idx = np.searchsorted(limits, a, side="left")
    counts = np.bincount(idx, minlength=len(limits)).astype(np.float64)
    return (float(a.min()), float(a.max()), float(a.size), float(a.sum()),
            float((a * a).sum()), counts[: len(limits)])


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _len_delimited(field, payload)


def encode_histo_value(tag_name: str, digest) -> bytes:
    """Summary.Value{tag=1, histo=4: HistogramProto} from a digest tuple.

    Consecutive empty buckets are collapsed (one zero-count bucket kept as
    separator), matching tf.summary.histogram's on-disk shape
    (reference train summaries: TLSAN/model.py:173-183)."""
    mn, mx, num, sm, ssq, counts = digest
    limits = tf_bucket_limits()
    keep_l, keep_c = [], []
    for i, c in enumerate(counts):
        nxt = counts[i + 1] if i + 1 < len(counts) else 0.0
        if c > 0 or nxt > 0:
            keep_l.append(float(limits[i]))
            keep_c.append(float(c))
    if not keep_l:  # empty tensor: one empty bucket keeps TB happy
        keep_l, keep_c = [float(limits[0])], [0.0]
    histo = (_tag(1, 1) + struct.pack("<d", mn)
             + _tag(2, 1) + struct.pack("<d", mx)
             + _tag(3, 1) + struct.pack("<d", num)
             + _tag(4, 1) + struct.pack("<d", sm)
             + _tag(5, 1) + struct.pack("<d", ssq)
             + _packed_doubles(6, keep_l)
             + _packed_doubles(7, keep_c))
    # Summary.Value: tag = field 1, histo (HistogramProto) = field 5
    return (_len_delimited(1, tag_name.encode("utf-8"))
            + _len_delimited(5, histo))


def encode_histo_event(step: int, wall_time: float, histos: Dict) -> bytes:
    summary = b"".join(_len_delimited(1, encode_histo_value(k, d))
                       for k, d in histos.items())
    ev = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        ev += _tag(2, 0) + _varint(step)
    ev += _len_delimited(5, summary)
    return ev


def encode_file_version(wall_time: float) -> bytes:
    # Event{wall_time=1, file_version=3 = "brain.Event:2"}
    return (_tag(1, 1) + struct.pack("<d", wall_time)
            + _len_delimited(3, b"brain.Event:2"))


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: len(8LE) + maskedcrc(len) + payload + maskedcrc."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str):
    """Inverse of frame_record — yields payload bytes, verifying CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == masked_crc32c(header), "header CRC mismatch"
            (n,) = struct.unpack("<Q", header)
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == masked_crc32c(payload), "payload CRC mismatch"
            yield payload


def decode_scalar_event(payload: bytes):
    """Decode wall_time/step/{tag: simple_value} from an Event payload
    (test/readback helper; tolerates only the fields we write)."""
    i, wall, step, scalars = 0, 0.0, 0, {}

    def rd_varint(buf, i):
        n = s = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << s
            if not b & 0x80:
                return n, i
            s += 7

    while i < len(payload):
        key, i = rd_varint(payload, i)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (val,) = struct.unpack_from("<d", payload, i)
            i += 8
            if field == 1:
                wall = val
        elif wire == 0:
            val, i = rd_varint(payload, i)
            if field == 2:
                step = val
        elif wire == 2:
            n, i = rd_varint(payload, i)
            blob = payload[i:i + n]
            i += n
            if field == 5:  # summary
                j = 0
                while j < len(blob):
                    vkey, j = rd_varint(blob, j)
                    vn, j = rd_varint(blob, j)
                    vblob = blob[j:j + vn]
                    j += vn
                    if vkey >> 3 == 1:
                        k = 0
                        tag_name, sval = "", None
                        while k < len(vblob):
                            fkey, k = rd_varint(vblob, k)
                            if fkey >> 3 == 1 and fkey & 7 == 2:
                                fn, k = rd_varint(vblob, k)
                                tag_name = vblob[k:k + fn].decode()
                                k += fn
                            elif fkey >> 3 == 2 and fkey & 7 == 5:
                                (sval,) = struct.unpack_from("<f", vblob, k)
                                k += 4
                            else:
                                raise ValueError("unexpected Value field")
                        if sval is not None:
                            scalars[tag_name] = sval
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return wall, step, scalars


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class TBEventWriter:
    """Append-only tfevents writer for scalar summaries.

    One instance ≡ one `tf.summary.FileWriter` (reference has train/ and
    eval/ sub-writers per model dir, TLSAN/model.py:17-19).
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version(time.time())))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float))}
        if not clean:
            return
        ev = encode_scalar_event(step, wall_time or time.time(), clean)
        self._f.write(frame_record(ev))
        self._f.flush()

    def add_histograms(self, step: int, histos: Dict,
                       wall_time: Optional[float] = None) -> None:
        """histos: {tag: digest} with digest =
        (min, max, num, sum, sum_squares, counts-over-tf_bucket_limits) —
        see histo_digest_np / the device-side digest in train/loop.py."""
        if not histos:
            return
        ev = encode_histo_event(step, wall_time or time.time(), histos)
        self._f.write(frame_record(ev))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
