"""The port's copy of ``resnet_tpu/utils/mxnet_params.py``.

MXNet ``.params`` binary checkpoint interchange (reader + writer).

The reference saves epoch checkpoints as ``{prefix}-{epoch:04d}.params``
via ``mx.model.save_checkpoint`` (SURVEY.md §3.4): a dmlc-serialized
``name -> NDArray`` list whose names carry ``arg:``/``aux:`` prefixes
(weights / BN running stats). This module implements that byte format
directly, so

- a user of the reference can point ``--model-prefix``/``--load-epoch``
  at their EXISTING MXNet checkpoints and keep training here, and
- checkpoints exported here load in MXNet with plain ``mx.nd.load``.

Byte layout (re-derived from knowledge of ``mxnet:src/c_api/c_api.cc``
``MXNDArraySave``, ``mxnet:src/ndarray/ndarray.cc`` ``NDArray::Save`` and
the dmlc-core stream serializer; ALL integers little-endian):

    uint64  0x112                 kMXAPINDArrayListMagic
    uint64  0                     reserved
    uint64  N                     number of arrays (dmlc vector header)
    N x NDArray:
        uint32  0xF993FAC9        NDARRAY_V2_MAGIC (V1 0xF993FAC8 is the
                                  legacy layout; V3 0xF993FACA is V2 with
                                  numpy shape semantics — both readable)
        int32   1                 storage type (kDefaultStorage; sparse
                                  rows/CSR are rejected loudly)
        uint32  ndim              TShape header
        int32[ndim] | int64[ndim] dims (standard MXNet builds serialize
                                  int32; large-tensor builds int64 — the
                                  reader disambiguates by validating the
                                  trailing context/dtype fields)
        int32   dev_type, int32 dev_id     (context; cpu = 1,0)
        int32   type_flag         0=f32 1=f64 2=f16 3=u8 4=i32 5=i8 6=i64
        raw     prod(dims) * itemsize bytes, C order
    uint64  N                     number of names (dmlc vector header)
    N x { uint64 len; bytes }     UTF-8 names, "arg:..."/"aux:..."

Provenance caveat: no MXNet install or reference artifact exists in this
environment (zero egress), so cross-validation against a genuine MXNet
file was impossible. The layout is pinned byte-for-byte by
``tests/test_export.py`` golden bytes, every magic/enum is validated on
read, and any mismatch raises with the offending offset instead of
misparsing silently. The ``.npz`` shim (utils/export.py) remains as the
always-works fallback.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

LIST_MAGIC = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA
_DEFAULT_STORAGE = 1
_CPU_DEV_TYPE = 1

# MXNet mshadow type flags <-> numpy dtypes
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
               4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


class MXNetParamsError(ValueError):
    """Raised (with the byte offset) on any layout mismatch."""


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise MXNetParamsError(
                f"truncated file: need {size} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}")
        out = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return out if len(out) > 1 else out[0]

    def raw(self, size: int) -> bytes:
        if self.pos + size > len(self.buf):
            raise MXNetParamsError(
                f"truncated payload: need {size} bytes at offset "
                f"{self.pos}, have {len(self.buf) - self.pos}")
        out = self.buf[self.pos:self.pos + size]
        self.pos += size
        return out


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.take("I")
    if magic == NDARRAY_V1_MAGIC:
        # legacy layout: shape (uint32 ndim + uint32 dims), no stype field
        ndim = r.take("I")
        dims = [r.take("I") for _ in range(ndim)]
    elif magic in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        stype = r.take("i")
        if stype != _DEFAULT_STORAGE:
            raise MXNetParamsError(
                f"storage type {stype} at offset {r.pos - 4}: only dense "
                "(kDefaultStorage=1) arrays are supported — sparse "
                "checkpoints do not occur in this model family")
        ndim = r.take("I")
        # standard MXNet builds serialize int32 dims; large-tensor builds
        # int64. Disambiguate by validating the fields that follow.
        dims, alt = None, None
        for fmt in ("i", "q"):
            save = r.pos
            try:
                cand = [r.take(fmt) for _ in range(ndim)]
                peek = r.pos
                dev_type, dev_id = r.take("ii")
                type_flag = r.take("i")
                plausible = (all(0 < d < 2**31 for d in cand)
                             and dev_type in (1, 2, 3, 5)
                             and 0 <= dev_id < 4096
                             and type_flag in _TYPE_FLAGS)
                r.pos = peek
                if plausible:
                    dims = cand
                    break
                alt = alt or (save, fmt)
            except MXNetParamsError:
                pass
            r.pos = save
        if dims is None:
            raise MXNetParamsError(
                f"cannot parse TShape at offset {r.pos}: neither int32 nor "
                "int64 dims yield a valid context/dtype — layout mismatch")
    else:
        raise MXNetParamsError(
            f"bad NDArray magic 0x{magic:08X} at offset {r.pos - 4} "
            "(expected V1/V2/V3 0xF993FAC8..A)")
    dev_type, dev_id = r.take("ii")
    if dev_type not in (1, 2, 3, 5):   # cpu, gpu, cpu_pinned, cpu_shared
        raise MXNetParamsError(
            f"implausible context dev_type {dev_type} at offset {r.pos - 8}")
    type_flag = r.take("i")
    if type_flag not in _TYPE_FLAGS:
        raise MXNetParamsError(
            f"unknown dtype flag {type_flag} at offset {r.pos - 4}")
    dtype = np.dtype(_TYPE_FLAGS[type_flag])
    count = int(np.prod(dims, dtype=np.int64)) if dims else 1
    data = r.raw(count * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(dims).copy()


def load_params(path: str) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray]]:
    """Read an MXNet ``.params`` file -> (arg_params, aux_params).

    Names without an ``arg:``/``aux:`` prefix (files written by bare
    ``mx.nd.save``) land in arg_params.
    """
    with open(path, "rb") as f:
        r = _Reader(f.read())
    header = r.take("Q")
    if header != LIST_MAGIC:
        raise MXNetParamsError(
            f"bad list magic 0x{header:X} (expected 0x{LIST_MAGIC:X}): "
            f"{path} is not an MXNet NDArray-list file")
    r.take("Q")  # reserved
    n = r.take("Q")
    if n > 1_000_000:
        raise MXNetParamsError(f"implausible array count {n}")
    arrays = [_read_ndarray(r) for _ in range(n)]
    n_names = r.take("Q")
    if n_names != n:
        raise MXNetParamsError(
            f"{n} arrays but {n_names} names — unnamed ndarray lists "
            "cannot be mapped to parameters")
    names = [r.raw(r.take("Q")).decode("utf-8") for _ in range(n_names)]
    if r.pos != len(r.buf):
        raise MXNetParamsError(
            f"{len(r.buf) - r.pos} trailing bytes after offset {r.pos}")
    args: Dict[str, np.ndarray] = {}
    auxs: Dict[str, np.ndarray] = {}
    for name, arr in zip(names, arrays):
        if name.startswith("arg:"):
            args[name[4:]] = arr
        elif name.startswith("aux:"):
            auxs[name[4:]] = arr
        else:
            args[name] = arr
    return args, auxs


def save_params(path: str, arg_params: Dict[str, np.ndarray],
                aux_params: Dict[str, np.ndarray]) -> None:
    """Write (arg_params, aux_params) as an MXNet-loadable ``.params``."""
    items = ([("arg:" + k, v) for k, v in sorted(arg_params.items())]
             + [("aux:" + k, v) for k, v in sorted(aux_params.items())])
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", LIST_MAGIC, 0, len(items)))
        for _, arr in items:
            arr = np.ascontiguousarray(arr)
            if arr.dtype not in _FLAG_OF:
                arr = arr.astype(np.float32)
            f.write(struct.pack("<Ii", NDARRAY_V2_MAGIC, _DEFAULT_STORAGE))
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}i", *arr.shape))
            f.write(struct.pack("<ii", _CPU_DEV_TYPE, 0))
            f.write(struct.pack("<i", _FLAG_OF[arr.dtype]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(items)))
        for name, _ in items:
            raw = name.encode("utf-8")
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
