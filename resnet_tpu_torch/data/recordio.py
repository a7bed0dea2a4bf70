"""The port's copy of ``resnet_tpu/data/recordio.py``. RecordIO container
format — wire-compatible with dmlc-core.

Re-implements the dmlc RecordIO framing (dmlc-core src/recordio.cc,
include/dmlc/recordio.h — SURVEY.md §2b row 1) so existing ``.rec``/``.idx``
datasets packed by MXNet's im2rec load unchanged, and shards we write load
in MXNet. This module is the pure-Python reference implementation (used for
packing, tests, and as the fallback reader); the hot read path is the C++
library in ``_native/`` bound via ctypes.

Wire format per record:
    uint32 magic = 0xced7230a
    uint32 lrec   (cflag = lrec >> 29, length = lrec & 0x1fffffff)
    length bytes of payload, zero-padded to 4-byte alignment
Payloads containing the magic value are split at each occurrence; pieces are
flagged 1/2/3 (start/middle/end) and the magic is re-inserted on read.

Image records carry MXNet's IRHeader (mxnet src/io/image_recordio.h):
    uint32 flag; float label; uint64 id; uint64 id2
followed by ``flag`` extra float labels (if any), then the encoded image.

The ``.idx`` sidecar is text lines ``<key>\t<byte offset>``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", MAGIC)
_LEN_MASK = (1 << 29) - 1
IRHEADER_FMT = "<IfQQ"
IRHEADER_SIZE = struct.calcsize(IRHEADER_FMT)   # 24


def _cflag(lrec: int) -> int:
    return lrec >> 29


def _length(lrec: int) -> int:
    return lrec & _LEN_MASK


class RecordIOWriter:
    """Sequential .rec writer (+ optional .idx sidecar)."""

    def __init__(self, rec_path: str, idx_path: Optional[str] = None):
        self._f = open(rec_path, "wb")
        self._idx = open(idx_path, "w") if idx_path else None
        self._nrec = 0

    def write(self, data: bytes, key: Optional[int] = None) -> None:
        if self._idx is not None:
            k = self._nrec if key is None else key
            self._idx.write(f"{k}\t{self._f.tell()}\n")
        # split payload at embedded magic values (dmlc WriteRecord)
        pieces: List[bytes] = []
        start = 0
        while True:
            i = data.find(_MAGIC_BYTES, start)
            # only split at 4-byte-aligned positions? dmlc scans uint32 words
            while i != -1 and i % 4 != 0:
                i = data.find(_MAGIC_BYTES, i + 1)
            if i == -1:
                pieces.append(data[start:])
                break
            pieces.append(data[start:i])
            start = i + 4
        n = len(pieces)
        for j, piece in enumerate(pieces):
            if n == 1:
                cf = 0
            elif j == 0:
                cf = 1
            elif j == n - 1:
                cf = 3
            else:
                cf = 2
            lrec = (cf << 29) | len(piece)
            self._f.write(_MAGIC_BYTES)
            self._f.write(struct.pack("<I", lrec))
            self._f.write(piece)
            pad = (-len(piece)) % 4
            if pad:
                self._f.write(b"\x00" * pad)
        self._nrec += 1

    def close(self) -> None:
        self._f.close()
        if self._idx is not None:
            self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader:
    """Sequential/random-access .rec reader. Every read is positional
    (``os.pread``), so one reader serves concurrent ``read_at`` calls (the
    Pillow loader decodes in a thread pool); a shared seek-then-read
    would hand one thread's bytes to another."""

    def __init__(self, rec_path: str, idx_path: Optional[str] = None):
        self._f = open(rec_path, "rb")
        self.size = os.fstat(self._f.fileno()).st_size
        self.offsets: Optional[List[int]] = None
        if idx_path and os.path.exists(idx_path):
            self.offsets = [
                int(line.split("\t")[1])
                for line in open(idx_path) if line.strip()]

    def read_at(self, offset: int) -> bytes:
        rec, _ = self._read_one(offset)
        if rec is None:
            raise EOFError(f"no record at offset {offset}")
        return rec

    def _read_one(self, pos: int) -> Tuple[Optional[bytes], int]:
        """(the record at byte ``pos`` or None at the end, the next
        record's position)."""
        fd = self._f.fileno()
        pieces: List[bytes] = []
        while True:
            head = os.pread(fd, 8, pos)
            if len(head) < 8:
                return None, pos
            magic, lrec = struct.unpack("<II", head)
            if magic != MAGIC:
                raise IOError(f"bad magic {magic:#x} at {pos}")
            cf, ln = _cflag(lrec), _length(lrec)
            pieces.append(os.pread(fd, ln, pos + 8))
            pos += 8 + ln + (-ln) % 4
            if cf == 0 and len(pieces) == 1:
                return pieces[0], pos
            if cf == 3:
                return _MAGIC_BYTES.join(pieces), pos

    def __iter__(self) -> Iterator[bytes]:
        pos = 0
        while True:
            rec, pos = self._read_one(pos)
            if rec is None:
                return
            yield rec

    def scan_offsets(self) -> List[int]:
        """Build offsets by scanning (when no .idx is present)."""
        offs = []
        pos = 0
        while True:
            rec, nxt = self._read_one(pos)
            if rec is None:
                break
            offs.append(pos)
            pos = nxt
        self.offsets = offs
        return offs

    def close(self):
        self._f.close()


# -- MXNet image-record payloads -------------------------------------------

@dataclass
class ImageRecord:
    label: float
    id: int
    extra_labels: Tuple[float, ...]
    image: bytes            # encoded (JPEG) bytes


def pack_image_record(image: bytes, label: float, rec_id: int = 0,
                      extra_labels: Tuple[float, ...] = ()) -> bytes:
    flag = len(extra_labels)
    head = struct.pack(IRHEADER_FMT, flag, float(label), rec_id, 0)
    extras = struct.pack(f"<{flag}f", *extra_labels) if flag else b""
    return head + extras + image


def unpack_image_record(data: bytes) -> ImageRecord:
    flag, label, rid, _ = struct.unpack_from(IRHEADER_FMT, data, 0)
    off = IRHEADER_SIZE
    extras: Tuple[float, ...] = ()
    if flag:
        extras = struct.unpack_from(f"<{flag}f", data, off)
        off += 4 * flag
        label = extras[0]
    return ImageRecord(label=label, id=rid, extra_labels=extras,
                       image=data[off:])
