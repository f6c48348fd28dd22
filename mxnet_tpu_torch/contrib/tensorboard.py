"""TensorBoard metric logging (``mx.contrib.tensorboard``; counterpart of
``mxnet_tpu/contrib/tensorboard.py``).

``LogMetricsCallback`` is a batch-end callback that writes each eval
metric as a scalar. The writer is ``torch.utils.tensorboard``'s or
tensorboardX's ``SummaryWriter`` where one imports, else the package's own
``_MiniEventWriter``: TFRecord framing (masked crc32c) around hand-encoded
``Event{wall_time, step, summary{value{tag, simple_value}}}`` protos, so
``tensorboard --logdir`` reads the files without TensorFlow. Its records
are byte for byte the JAX package's for the same tags, steps and values,
but for the wall time.
"""
from __future__ import annotations

import os
import struct
import time


def _masked_crc32c(data: bytes) -> int:
    """CRC32C with the TFRecord masking (the event-file framing checksum)."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


_CRC_TABLE = []


def _crc32c(buf: bytes) -> int:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in buf:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _varint(n: int) -> bytes:
    # two's-complement 64-bit: a negative step (the common sentinel -1)
    # terminates, as protobuf's int64 varint does
    n &= (1 << 64) - 1
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _proto_field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    """Hand-encoded Event{wall_time, step, summary{value{tag, simple_value}}}."""
    tag_b = tag.encode()
    sv = _proto_field(1, 2) + _varint(len(tag_b)) + tag_b
    sv += _proto_field(2, 5) + struct.pack("<f", float(value))
    summary_value = _proto_field(1, 2) + _varint(len(sv)) + sv
    event = _proto_field(1, 1) + struct.pack("<d", wall)
    event += _proto_field(2, 0) + _varint(int(step))
    event += _proto_field(5, 2) + _varint(len(summary_value)) + summary_value
    return event


class _MiniEventWriter:
    """A minimal TF event-file writer (record framing per the TFRecord
    format)."""

    _seq = 0

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        # a timestamp alone collides when two writers start within a second
        # (train and eval callbacks on one logdir): pid and a sequence too
        _MiniEventWriter._seq += 1
        fname = "events.out.tfevents.%d.%d.%d.mxtpu" % (
            int(time.time()), os.getpid(), _MiniEventWriter._seq)
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_event(_proto_field(1, 1) + struct.pack("<d", time.time()))

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc32c(payload)))

    def add_scalar(self, tag, value, global_step=0):
        self._write_event(_scalar_event(tag, value, global_step, time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logdir):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir)
    except Exception:
        pass
    return _MiniEventWriter(logdir)


class LogMetricsCallback:
    """A batch-end callback writing the eval metrics as TensorBoard scalars
    (``prefix-name``), one step a call."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _make_writer(logging_dir)

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
        self.summary_writer.flush()
