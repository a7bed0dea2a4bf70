"""Convert a checkpoint to the reference's checkpoint pair. Port of
``tools/export_mxnet.py``.

    python -m resnet_tpu_torch.tools.export_mxnet --out /tmp/export/model \\
        -- <train_resnet flags> --model-prefix ck --load-epoch 30

Writes ``{out}-symbol.json`` (the NNVM graph, ``utils/symbol_export.py``)
and ``{out}-{epoch:04d}.params`` (the dmlc NDArray-list binary,
``utils/mxnet_params.py``): the file pair ``mx.model.save_checkpoint``
writes, which ``mx.model.load_checkpoint`` and the JAX package read. The
weights come from the port's checkpoint of ``--load-epoch``, else from
``{prefix}-NNNN.params``; the network is the one the flags name. Runs on
the CUDA card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import os
import sys

from resnet_tpu_torch.tools.common import load_trained, tool_config
from resnet_tpu_torch.utils.export import save_mxnet_style
from resnet_tpu_torch.utils.symbol_export import save_symbol


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True,
                   help="output prefix for the -symbol.json/.params pair")
    args, rest = p.parse_known_args(argv)
    rest = [a for a in rest if a != "--"]
    cfg, device = tool_config(rest)
    if cfg.train.load_epoch is None:
        print("error: --load-epoch required", file=sys.stderr)
        return 2
    cfg, state = load_trained(cfg, device, use_symbol=False)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    print(save_symbol(args.out, cfg))
    print(save_mxnet_style(args.out, cfg.train.load_epoch, state,
                           fmt="params"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
