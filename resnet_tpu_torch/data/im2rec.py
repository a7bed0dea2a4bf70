"""im2rec (the port's copy of ``resnet_tpu/data/im2rec.py``) — pack an image tree into RecordIO shards (.rec + .idx).

The rebuild of mxnet tools/im2rec.py (SURVEY.md §2a last row): walks a
``root/class_name/*.jpg`` tree (or takes an explicit ``.lst`` file of
``index\tlabel\tpath`` lines), re-encodes each image as JPEG at the
requested quality/size, and writes dmlc-framed shards our native reader
(and MXNet itself) can consume.

Usage:
    python -m resnet_tpu_torch.data.im2rec --root /data/train --prefix train \
        --resize 256 --quality 95 [--num-shards 1] [--list-only]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import List, Tuple

from resnet_tpu_torch.data.recordio import RecordIOWriter, pack_image_record

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def build_list(root: str) -> List[Tuple[int, float, str]]:
    """(index, label, relpath) entries; labels are sorted class-dir indices
    (the im2rec convention)."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    entries = []
    i = 0
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if os.path.splitext(fname)[1].lower() in IMG_EXTS:
                entries.append((i, float(label), os.path.join(cls, fname)))
                i += 1
    return entries


def write_list(entries, lst_path: str) -> None:
    with open(lst_path, "w") as f:
        for idx, label, rel in entries:
            f.write(f"{idx}\t{label:g}\t{rel}\n")


def read_list(lst_path: str) -> List[Tuple[int, float, str]]:
    out = []
    for line in open(lst_path):
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 3:
            continue
        out.append((int(parts[0]), float(parts[1]), parts[2]))
    return out


def encode_image(path: str, resize: int = 0, quality: int = 95) -> bytes:
    """Load -> optional shorter-side resize -> JPEG bytes (PIL backend)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if resize:
        w, h = img.size
        if min(w, h) != resize:
            if w < h:
                nw, nh = resize, max(1, round(h * resize / w))
            else:
                nw, nh = max(1, round(w * resize / h)), resize
            img = img.resize((nw, nh), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def pack(root: str, prefix: str, entries, resize: int = 0,
         quality: int = 95, num_shards: int = 1) -> None:
    per = (len(entries) + num_shards - 1) // num_shards
    for s in range(num_shards):
        chunk = entries[s * per:(s + 1) * per]
        suffix = f"_{s:03d}" if num_shards > 1 else ""
        rec_path = f"{prefix}{suffix}.rec"
        idx_path = f"{prefix}{suffix}.idx"
        with RecordIOWriter(rec_path, idx_path) as w:
            for idx, label, rel in chunk:
                img = encode_image(os.path.join(root, rel), resize, quality)
                w.write(pack_image_record(img, label, rec_id=idx), key=idx)
        print(f"wrote {rec_path}: {len(chunk)} records")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="image tree root")
    p.add_argument("--prefix", required=True, help="output prefix")
    p.add_argument("--lst", default=None,
                   help="existing .lst (index\\tlabel\\tpath); default: "
                        "build from class subdirs")
    p.add_argument("--resize", type=int, default=0,
                   help="shorter-side resize before encode (0 = keep)")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--list-only", action="store_true",
                   help="only write the .lst file")
    args = p.parse_args(argv)

    entries = read_list(args.lst) if args.lst else build_list(args.root)
    if not args.lst:
        write_list(entries, f"{args.prefix}.lst")
        print(f"wrote {args.prefix}.lst: {len(entries)} entries")
    if args.list_only:
        return 0
    pack(args.root, args.prefix, entries, args.resize, args.quality,
         args.num_shards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
