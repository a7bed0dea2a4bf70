"""The record loaders: the C++ decode pool (``_native/recordio_loader.cc``)
bound with ctypes, and its pure-Python twin. Port of
``resnet_tpu/data/native.py``.

The C++ source is built with ``g++`` at first use into
``resnet_tpu_torch/_build/librecordio_loader-<hash>.so``. The hash covers
the source, the flags, the compiler's version and what ``-march=native``
resolves to on this machine, so a build made on another machine is never
loaded. Concurrent builders (test workers) each compile to a temporary name
and ``os.replace`` it into place.

Calls into the library release the GIL (ctypes does this), so the decode
pool runs beside the training loop. Loaders accept a list of .rec shards;
records are read with pread, so memory stays flat whatever the pack size.

Canvas modes:
  - ``letterbox=False``: shorter-side resize + centre crop, the val
    transform (resize-256 / crop-224 for the default shapes).
  - ``letterbox=True``: the whole image fit inside the canvas (top-left,
    zero pad) + per-image dims (orig_h, orig_w, eff_h, eff_w), so the
    on-device random-resized-crop samples the full image.

``make_record_loader`` picks the native loader and takes the Pillow one
when the C++ build fails (this machine lacks ``g++`` or libjpeg); it logs
which one it chose, and the loader's ``kind`` says it too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_log = logging.getLogger("resnet_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "_native" / "recordio_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the JAX package's Makefile flags, so both builds decode alike
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-pthread", "-shared"]
LIBS = ["-ljpeg"]

Paths = Union[str, Sequence[str]]


class NativeUnavailable(RuntimeError):
    pass


def _as_list(paths: Optional[Paths]) -> List[str]:
    if paths is None:
        return []
    if isinstance(paths, str):
        return [paths]
    return list(paths)


def _compiler_identity(cxx: str) -> bytes:
    """The compiler's version and the target options ``-march=native``
    stands for here."""
    out = []
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        res = subprocess.run([cxx, *args], capture_output=True, text=True,
                             check=True)
        out.append(res.stdout)
    return "\n".join(out).encode()


def library_path() -> Path:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) on PATH")
    try:
        ident = _compiler_identity(cxx)
    except (subprocess.CalledProcessError, OSError) as e:
        raise NativeUnavailable(f"{cxx} does not run: {e}") from e
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + ident)
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librecordio_loader-{digest.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Build the decode pool unless this machine's build exists; returns
    its path. Raises ``NativeUnavailable`` if the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"native loader build failed: {detail}") \
            from e
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    lib.rtpu_open.restype = ctypes.c_int
    lib.rtpu_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.rtpu_num_records.restype = ctypes.c_long
    lib.rtpu_num_records.argtypes = [ctypes.c_void_p]
    lib.rtpu_begin_epoch.restype = ctypes.c_int
    lib.rtpu_begin_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
    lib.rtpu_skip.restype = ctypes.c_int
    lib.rtpu_skip.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.rtpu_next_batch.restype = ctypes.c_int
    lib.rtpu_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.rtpu_close.restype = None
    lib.rtpu_close.argtypes = [ctypes.c_void_p]
    return lib


def _letterbox_dims(ih: int, iw: int, ch: int, cw: int) -> Tuple[int, int]:
    """Effective letterboxed dims — MUST match DecodeToLetterbox's rounding
    (int(x + 0.5), clamped to [1, canvas])."""
    scale = min(ch / ih, cw / iw)
    eh = min(ch, max(1, int(ih * scale + 0.5)))
    ew = min(cw, max(1, int(iw * scale + 0.5)))
    return eh, ew


class PythonRecordLoader:
    """Pure-Python twin of ``NativeRecordLoader``: Pillow decode and a
    Pillow bilinear canvas. ``threads > 1`` decodes in a thread pool
    (Pillow releases the GIL during JPEG decode)."""

    kind = "python"

    def __init__(self, rec_path: Paths, idx_path: Optional[Paths],
                 canvas_hw: Tuple[int, int], threads: int = 0,
                 num_parts: int = 1, part_index: int = 0,
                 letterbox: bool = False):
        from resnet_tpu_torch.data.recordio import RecordIOReader
        recs = _as_list(rec_path)
        idxs = _as_list(idx_path)
        self._readers = []
        entries = []  # (shard, offset) over the global shard sequence
        for s, rec in enumerate(recs):
            idx = idxs[s] if s < len(idxs) else None
            reader = RecordIOReader(rec, idx)
            if reader.offsets is None:
                reader.scan_offsets()
            self._readers.append(reader)
            entries.extend((s, off) for off in reader.offsets)
        self._entries = entries[part_index::num_parts]
        self.canvas_hw = canvas_hw
        self.letterbox = letterbox
        self.threads = max(1, threads)
        self.num_records = len(self._entries)
        self._order = np.arange(self.num_records)
        self._cursor = 0
        self._decode_failures = 0

    @property
    def records_consumed(self) -> int:
        """Epoch cursor position (records pulled, INCLUDING corrupt ones
        that were dropped) — the mid-epoch-resume seek unit."""
        return int(self._cursor)

    def begin_epoch(self, epoch: int, shuffle: bool, seed: int) -> None:
        self._cursor = 0
        self._order = np.arange(self.num_records)
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(self._order)

    def skip(self, n: int) -> None:
        self._cursor = min(self.num_records, self._cursor + n)

    def _decode_one(self, i, images, labels, dims):
        import io as _io

        from PIL import Image

        from resnet_tpu_torch.data.recordio import unpack_image_record
        h, w = self.canvas_hw
        shard, off = self._entries[self._order[self._cursor + i]]
        try:
            rec = unpack_image_record(self._readers[shard].read_at(off))
            img = Image.open(_io.BytesIO(rec.image)).convert("RGB")
        except Exception:
            # corrupt record (any decode error Pillow or the header parse
            # raises): mark for the caller to drop, exactly like the
            # native loader (label -1 sentinel)
            images[i] = 0
            labels[i] = -1.0
            dims[i] = (1, 1, 1, 1)
            return
        iw, ih = img.size
        if self.letterbox:
            eh, ew = _letterbox_dims(ih, iw, h, w)
            img = img.resize((ew, eh), Image.BILINEAR)
            canvas = np.zeros((h, w, 3), np.uint8)
            canvas[:eh, :ew] = np.asarray(img)
            images[i] = canvas
            dims[i] = (ih, iw, eh, ew)
        else:
            scale = max(h / ih, w / iw)
            rw, rh = max(w, round(iw * scale)), max(h, round(ih * scale))
            img = img.resize((rw, rh), Image.BILINEAR)
            x0, y0 = (rw - w) // 2, (rh - h) // 2
            images[i] = np.asarray(img)[y0:y0 + h, x0:x0 + w]
            dims[i] = (ih, iw, h, w)
        labels[i] = rec.label

    def next_batch(self, batch_size: int):
        h, w = self.canvas_hw
        todo = min(batch_size, self.num_records - self._cursor)
        images = np.empty((todo, h, w, 3), np.uint8)
        labels = np.empty((todo,), np.float32)
        dims = np.empty((todo, 4), np.int32)
        if self.threads > 1 and todo > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.threads) as pool:
                list(pool.map(
                    lambda i: self._decode_one(i, images, labels, dims),
                    range(todo)))
        else:
            for i in range(todo):
                self._decode_one(i, images, labels, dims)
        self._cursor += todo
        keep = labels >= 0.0
        if not keep.all():
            bad = int(todo - keep.sum())
            self._decode_failures += bad
            _log.warning(
                "record loader (python): %d corrupt record(s) skipped "
                "(%d total this loader)", bad, self._decode_failures)
            images, labels, dims = images[keep], labels[keep], dims[keep]
        if self.letterbox:
            return images, labels, dims
        return images, labels, None

    def close(self) -> None:
        for r in self._readers:
            r.close()


class NativeRecordLoader:
    """A .rec shard set -> uint8 canvas batches, decoded by the C++ pool."""

    kind = "native"

    def __init__(self, rec_path: Paths, idx_path: Optional[Paths],
                 canvas_hw: Tuple[int, int], threads: int = 4,
                 num_parts: int = 1, part_index: int = 0,
                 letterbox: bool = False):
        lib = get_lib()
        handle = ctypes.c_void_p()
        recs = _as_list(rec_path)
        idxs = _as_list(idx_path)
        rc = lib.rtpu_open(
            "\n".join(recs).encode(), "\n".join(idxs).encode(),
            canvas_hw[0], canvas_hw[1], threads, num_parts, part_index,
            1 if letterbox else 0, ctypes.byref(handle))
        if rc != 0:
            raise IOError(f"rtpu_open({recs}) failed rc={rc}")
        self._lib = lib
        self._h = handle
        self.canvas_hw = canvas_hw
        self.letterbox = letterbox
        self.num_records = int(lib.rtpu_num_records(self._h))
        self._decode_failures = 0
        self._consumed = 0

    @property
    def records_consumed(self) -> int:
        """Epoch cursor position (records pulled, INCLUDING corrupt ones
        that were dropped) — the mid-epoch-resume seek unit."""
        return self._consumed

    def begin_epoch(self, epoch: int, shuffle: bool, seed: int) -> None:
        self._lib.rtpu_begin_epoch(self._h, epoch, int(shuffle),
                                   seed & 0xFFFFFFFF)
        self._consumed = 0

    def skip(self, n: int) -> None:
        """Advance the epoch cursor without decoding (mid-epoch resume)."""
        self._lib.rtpu_skip(self._h, int(n))
        self._consumed += int(n)

    def next_batch(self, batch_size: int):
        """Returns (images uint8 (n,H,W,3), labels float32 (n,), dims) with
        n <= batch_size; n < batch_size means epoch exhausted. ``dims`` is
        int32 (n,4) = (orig_h, orig_w, eff_h, eff_w) when letterboxing,
        else None."""
        h, w = self.canvas_hw
        images = np.empty((batch_size, h, w, 3), np.uint8)
        labels = np.empty((batch_size,), np.float32)
        dims = np.empty((batch_size, 4), np.int32)
        count = ctypes.c_int(0)
        rc = self._lib.rtpu_next_batch(
            self._h, batch_size,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(count))
        n = count.value
        self._consumed += int(n)
        keep = slice(None)
        if rc < 0:
            # -rc records failed to decode; the C side zero-fills them and
            # marks label -1. The reference skips corrupt records, so they
            # are filtered out of the batch.
            keep = labels[:n] >= 0.0
            self._decode_failures += int(n - keep.sum())
            _log.warning(
                "record loader: %d corrupt record(s) skipped "
                "(%d total this loader)", -rc, self._decode_failures)
        if self.letterbox:
            return images[:n][keep], labels[:n][keep], dims[:n][keep]
        return images[:n][keep], labels[:n][keep], None

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.rtpu_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def make_record_loader(rec_path: Paths, idx_path: Optional[Paths],
                       canvas_hw: Tuple[int, int], threads: int = 4,
                       num_parts: int = 1, part_index: int = 0,
                       letterbox: bool = False):
    """Native loader, or the Pillow one if the C++ build fails."""
    try:
        loader = NativeRecordLoader(rec_path, idx_path, canvas_hw, threads,
                                    num_parts, part_index, letterbox)
    except NativeUnavailable as e:
        _log.warning("record loader: native build unavailable (%s); "
                     "decoding with Pillow", str(e).splitlines()[0])
        loader = PythonRecordLoader(rec_path, idx_path, canvas_hw, threads,
                                    num_parts, part_index, letterbox)
    _log.info("record loader: %s, %d records, canvas %dx%d, %d threads",
              loader.kind, loader.num_records, canvas_hw[0], canvas_hw[1],
              threads)
    return loader
