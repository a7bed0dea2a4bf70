"""Batch inference: classify images with a trained checkpoint. Port of
``tools/predict.py``.

Point it at image files, a directory, or a ``.rec`` shard; it prints the
top-k classes of each input as JSON lines, in the JAX tool's format.
``{prefix}-symbol.json`` sets the network unless ``--no-symbol-config``;
the weights come from the port's checkpoint of ``--load-epoch``, else
from ``{prefix}-NNNN.params``.

    python -m resnet_tpu_torch.tools.predict --inputs img1.jpg img2.jpg \\
        [--top-k 5] -- --preset imagenet_resnet50 \\
        --model-prefix checkpoints/resnet --load-epoch 90
    python -m resnet_tpu_torch.tools.predict --inputs val.rec --limit 64 \\
        -- ... --device cpu

Runs on the CUDA card unless ``--device cpu``; without a card it raises.
Images are decoded with Pillow.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np
import torch
from PIL import Image

from resnet_tpu_torch.data.recordio import RecordIOReader, unpack_image_record
from resnet_tpu_torch.tools.common import load_trained, tool_config
from resnet_tpu_torch.utils.serving import make_serving_fn

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def _load_image(path, canvas_hw):
    """Resize the short side to the canvas, then centre-crop it."""
    img = Image.open(path).convert("RGB")
    w, h = img.size
    ch, cw = canvas_hw
    scale = max(ch / h, cw / w)
    rw, rh = max(cw, round(w * scale)), max(ch, round(h * scale))
    img = img.resize((rw, rh), Image.BILINEAR)
    x0, y0 = (rw - cw) // 2, (rh - ch) // 2
    return np.asarray(img)[y0:y0 + ch, x0:x0 + cw]


def _iter_inputs(paths, canvas_hw, limit):
    """Yield (name, uint8 canvas HWC) from files, directories and ``.rec``
    shards; a record's image is resized to the canvas whole."""
    count = 0
    for path in paths:
        if os.path.isdir(path):
            for f in sorted(os.listdir(path)):
                if count >= limit:
                    return
                fp = os.path.join(path, f)
                if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS:
                    yield fp, _load_image(fp, canvas_hw)
                    count += 1
        elif path.endswith(".rec"):
            for i, rec in enumerate(RecordIOReader(path)):
                if count >= limit:
                    return
                r = unpack_image_record(rec)
                img = Image.open(io.BytesIO(r.image)).convert("RGB")
                yield f"{path}#{i}", np.asarray(
                    img.resize(canvas_hw[::-1], Image.BILINEAR))
                count += 1
        else:
            if count >= limit:
                return
            yield path, _load_image(path, canvas_hw)
            count += 1


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--inputs", nargs="+", required=True,
                   help="image files, directories, or .rec shards")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--limit", type=int, default=1 << 30)
    p.add_argument("--no-symbol-config", action="store_true",
                   help="do NOT read the model structure from "
                        "{prefix}-symbol.json when it exists (by default "
                        "a foreign MXNet checkpoint pair configures the "
                        "network itself, like mx.model.load_checkpoint)")
    args, rest = p.parse_known_args(argv)
    rest = [a for a in rest if a != "--"]
    cfg, device = tool_config(rest)
    if cfg.train.load_epoch is None:
        print("error: --load-epoch required", file=sys.stderr)
        return 2
    cfg, state = load_trained(cfg, device,
                              use_symbol=not args.no_symbol_config)
    names, imgs = [], []
    for name, img in _iter_inputs(args.inputs, cfg.data.image_shape[:2],
                                  args.limit):
        names.append(name)
        imgs.append(img)
    if not imgs:
        print("error: no inputs found", file=sys.stderr)
        return 2
    serve = make_serving_fn(cfg, state.model)
    with torch.inference_mode():
        logits = serve(torch.from_numpy(np.stack(imgs)).to(device))
        probs = torch.softmax(logits, dim=-1)
        # stable, as jnp.argsort: ties keep the lower class first
        top = torch.argsort(-probs, dim=-1, stable=True)[:, :args.top_k]
        top_p = torch.gather(probs, 1, top)
    for name, t, pr in zip(names, top.cpu().tolist(), top_p.cpu().tolist()):
        print(json.dumps({
            "input": name,
            "top_k": [{"class": int(c), "prob": round(float(q), 5)}
                      for c, q in zip(t, pr)],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
