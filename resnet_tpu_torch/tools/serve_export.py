"""Export a trained checkpoint as a self-contained serving artifact. Port
of ``tools/serve_export.py``.

The deployment half of the reference workflow (train -> save_checkpoint
-> load_checkpoint in a serving process): ``torch.export`` captures the
inference program (weights inside, uint8 in, float32 logits out, a
symbolic batch) instead of a symbol-JSON + params pair that needs the
framework at serving time. See ``resnet_tpu_torch/utils/serving.py``.

    python -m resnet_tpu_torch.tools.serve_export --out model_artifact \\
        [--serve-batch-size 8] [--platforms cpu cuda] [--check] \\
        -- --preset imagenet_resnet50 --model-prefix ckpt/resnet \\
        --load-epoch 90

Serving then needs only torch:

    from resnet_tpu_torch.utils.serving import load_serving
    serve, manifest = load_serving("model_artifact")       # the card
    logits = serve(u8_nhwc_batch)

The checkpoint is found as ``predict`` finds it. Runs on the CUDA card
unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from resnet_tpu_torch.tools.common import load_trained, tool_config
from resnet_tpu_torch.utils.serving import (PLATFORMS, export_serving,
                                            load_serving, make_serving_fn)

CHECK_TOL = 1e-3


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True,
                   help="artifact prefix (writes <out>.pt2 + <out>.json)")
    p.add_argument("--serve-batch-size", type=int, default=None,
                   help="pin the artifact batch dim (default: symbolic - "
                        "one artifact serves any batch size)")
    p.add_argument("--platforms", nargs="+", default=list(PLATFORMS))
    p.add_argument("--serve-devices", type=int, default=1,
                   help="export for N devices: the batch is split into N "
                        "blocks, one copy of the program a card; the "
                        "artifact then needs N cards at load time")
    p.add_argument("--check", action="store_true",
                   help="after export, reload the artifact on the device "
                        "and verify its logits match the live model on a "
                        "random batch")
    p.add_argument("--no-symbol-config", action="store_true",
                   help="do NOT read model structure from "
                        "{prefix}-symbol.json")
    args, rest = p.parse_known_args(argv)
    rest = [a for a in rest if a != "--"]
    cfg, device = tool_config(rest)
    if cfg.train.load_epoch is None:
        print("error: --load-epoch required", file=sys.stderr)
        return 2
    cfg, state = load_trained(cfg, device,
                              use_symbol=not args.no_symbol_config)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    artifact, manifest = export_serving(
        cfg, state.model, args.out, batch_size=args.serve_batch_size,
        platforms=args.platforms, num_devices=args.serve_devices)
    print(f"wrote {artifact} ({os.path.getsize(artifact) / 1e6:.1f} MB) "
          f"+ {manifest}")

    if args.check:
        serve, _ = load_serving(args.out, device=device)
        h, w, c = cfg.data.image_shape
        bs = args.serve_batch_size or 2 * args.serve_devices
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (bs, h, w, c), dtype=np.uint8)).to(device)
        got = serve(x)
        with torch.inference_mode():
            want = make_serving_fn(cfg, state.model)(x)
        err = float((got - want).abs().max())
        print(f"check: artifact-vs-live max |dlogit| = {err:.2e}")
        if not torch.allclose(got, want, atol=CHECK_TOL, rtol=CHECK_TOL):
            print("error: artifact logits diverge from the live model",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
