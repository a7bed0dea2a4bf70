"""Standalone validation, port of ``tools/validate.py``: the reference's
end-of-epoch ``score()`` as a tool. Loads a checkpoint, runs the eval
pipeline and prints the metric trio.

    python -m resnet_tpu_torch.tools.validate --preset imagenet_resnet50 \\
        --model-prefix checkpoints/resnet --load-epoch 90 \\
        --pipeline record --data-dir /data/imagenet

Started by ``python -m resnet_tpu_torch.tools.launch -n N -- ...`` it
joins the process group, and each rank validates its share. Runs on the
CUDA card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import sys

from resnet_tpu_torch.data.loader import make_val_iter
from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                            maybe_init_distributed,
                                            proc_info)
from resnet_tpu_torch.tools.common import tool_config
from resnet_tpu_torch.train.solver import Solver


def main(argv=None):
    cfg, device = tool_config(argv)
    if cfg.train.load_epoch is None:
        print("error: --load-epoch is required", file=sys.stderr)
        return 2
    maybe_init_distributed(device)
    num_parts, part_index = proc_info()
    solver = Solver(cfg, device=device)
    state = solver.init_state()
    val_iter = make_val_iter(cfg, num_parts, part_index)
    if val_iter is None:
        print("error: no validation data for this pipeline",
              file=sys.stderr)
        return 2
    m = solver.validate(state, val_iter, cfg.train.load_epoch)
    finalize_distributed()
    print({k: round(v, 6) for k, v in m.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
