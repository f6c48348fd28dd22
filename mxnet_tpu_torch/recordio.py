"""RecordIO: the binary record container, its indexed variant and the
image record header (counterpart of ``mxnet_tpu/recordio.py``).

The same on-disk bytes as the JAX package and the reference MXNet: magic
``0xced7230a``, then ``lrec`` (the length, with a continuation flag in its
top 3 bits), the payload, and zero padding to 4 bytes. Records written by
either package read in the other. A record file is read and written
through the native runtime (``src/recordio.cc``, built by
:mod:`._native`) when it is available, and in Python under
``MXNET_TPU_NO_NATIVE=1`` or without a library: the same bytes either
way.
"""
from __future__ import annotations

import ctypes
import numbers
import os
import struct

import numpy as np

from . import _native
from .base import MXNetError

_MAGIC = 0xCED7230A
_LREC_HEADER = struct.Struct("<II")  # magic, lrec(len + cflag<<29)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return (lrec >> 29) & 7, lrec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``flag="w"``),
    native when the runtime is available (``_nat`` holds the library and
    the native handle), else Python."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self._nat = None
        self.open()

    def open(self):
        lib = _native.get_lib()
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        if lib is not None:
            uri = self.uri.encode()
            h = (lib.MXTRecordIOWriterCreate(uri) if self.writable
                 else lib.MXTRecordIOReaderCreate(uri))
            if not h:
                raise MXNetError(_native.last_error()
                                 or "cannot open %s" % self.uri)
            self._nat = (lib, h)
        else:
            self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.pid = os.getpid()

    def close(self):
        if self._nat is not None:
            lib, h = self._nat
            self._nat = None
            (lib.MXTRecordIOWriterClose if self.writable
             else lib.MXTRecordIOReaderClose)(h)
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["_nat"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self.flag == "w":
            # reopen for append after unpickling in a worker process
            self.handle = open(self.uri, "ab")
        else:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        if self._nat is not None:
            lib, h = self._nat
            return (lib.MXTRecordIOWriterTell if self.writable
                    else lib.MXTRecordIOReaderTell)(h)
        return self.handle.tell()

    def seek(self, pos):
        if self.writable:
            raise MXNetError("seek on a writable recordio")
        if self._nat is not None:
            lib, h = self._nat
            if lib.MXTRecordIOReaderSeek(h, pos) != 0:
                raise MXNetError("recordio seek(%d) failed: %s"
                                 % (pos, _native.last_error()))
        else:
            self.handle.seek(pos)

    def write(self, buf):
        assert self.writable
        if not isinstance(buf, bytes):
            buf = bytes(buf)
        if self._nat is not None:
            lib, h = self._nat
            if lib.MXTRecordIOWriterWrite(h, buf, len(buf)) != 0:
                raise MXNetError("recordio write failed: %s"
                                 % _native.last_error())
            return
        self.handle.write(_LREC_HEADER.pack(_MAGIC, _encode_lrec(0, len(buf))))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        assert not self.writable
        if self._nat is not None:
            lib, h = self._nat
            out = ctypes.c_char_p()
            size = ctypes.c_size_t()
            rc = lib.MXTRecordIOReaderNext(h, ctypes.byref(out),
                                           ctypes.byref(size))
            if rc == 0:
                return None
            if rc < 0:
                raise MXNetError("recordio read failed: %s"
                                 % _native.last_error())
            return ctypes.string_at(out, size.value)
        # split-record reassembly (cflag 1 = first, 2 = middle, 3 = last
        # chunk; dmlc splits payloads at embedded magic words and the
        # reader re-inserts them)
        parts = []
        in_split = False
        while True:
            header = self.handle.read(8)
            if len(header) < 8:
                if in_split:
                    raise MXNetError("truncated split record")
                return None if not parts else b"".join(parts)
            magic, lrec = _LREC_HEADER.unpack(header)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic %x" % magic)
            cflag, length = _decode_lrec(lrec)
            if in_split:
                parts.append(_LREC_HEADER.pack(_MAGIC, 0)[:4])  # the magic
            parts.append(self.handle.read(length))
            pad = (4 - (length % 4)) % 4
            if pad:
                self.handle.read(pad)
            if cflag in (0, 3):
                return b"".join(parts)
            if cflag in (1, 2):
                in_split = True
                continue
            raise MXNetError("unknown cflag %d in recordio stream" % cflag)


class MXIndexedRecordIO(MXRecordIO):
    """Records addressed by key through a ``.idx`` file of ``key\\toffset``
    lines."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# image record header binary layout (flag, label, id, id2)
_IR_STRUCT = struct.Struct("IfQQ")


class _HeaderTuple(tuple):
    @property
    def flag(self):
        return self[0]

    @property
    def label(self):
        return self[1]

    @property
    def id(self):
        return self[2]

    @property
    def id2(self):
        return self[3]


def IRHeader(flag, label, id, id2):  # noqa: A002 — reference signature
    """The image record header ``(flag, label, id, id2)``."""
    return _HeaderTuple((flag, label, id, id2))


def pack(header, s):
    """A ``(flag, label, id, id2)`` header and payload bytes as one record.

    Multi-label: ``flag`` holds the label count and the float32 labels are
    prepended to the payload."""
    flag, label, idx, idx2 = header
    if isinstance(label, numbers.Number):
        hdr = _IR_STRUCT.pack(flag, float(label), int(idx), int(idx2))
    else:
        label = np.asarray(label, dtype=np.float32)
        hdr = _IR_STRUCT.pack(len(label), 0.0, int(idx), int(idx2))
        s = label.tobytes() + s
    return hdr + s


def unpack(s):
    """A record as ``(header, payload)``."""
    hdr = _HeaderTuple(_IR_STRUCT.unpack(s[: _IR_STRUCT.size]))
    s = s[_IR_STRUCT.size :]
    if hdr.flag > 0:
        n = hdr.flag
        label = np.frombuffer(s[: 4 * n], dtype=np.float32)
        return _HeaderTuple((hdr.flag, label, hdr.id, hdr.id2)), s[4 * n :]
    return hdr, s


def unpack_img(s, iscolor=1):
    """A record as ``(header, decoded HWC uint8 image)``."""
    hdr, img_bytes = unpack(s)
    from .image.image import imdecode_bytes

    return hdr, imdecode_bytes(img_bytes, iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A header and an encoded image as one record."""
    from .image.image import imencode_bytes

    return pack(header, imencode_bytes(img, img_fmt, quality))
