"""Serving export: a self-contained inference artifact. Port of
``resnet_tpu/utils/serving.py``.

The reference deploys a ``prefix-symbol.json`` + ``prefix-NNNN.params``
pair, which needs the framework to rebuild the network at serving time.
Here ``torch.export`` captures the inference PROGRAM with the trained
weights inside it (an ``ExportedProgram``, saved with
``torch.export.save``). The artifact

  - takes raw uint8 NHWC canvases: the mean/std normalize is inside the
    program, so a request moves 1 byte a pixel to the card;
  - runs the model in eval mode (running-statistics BatchNorm) in the
    compute dtype and returns float32 logits;
  - has a SYMBOLIC batch dimension by default (``torch.export.Dim``), so
    one file serves any batch size, batch 1 included;
  - is written once, on the CPU, and loads on the CPU or on the card:
    :func:`load_serving` moves the program to the requested device with
    ``move_to_device_pass``;
  - can be written for N devices (``num_devices=N``): the batch is then a
    multiple of N, and the loader runs one copy of the program per card
    on N equal blocks of the batch;
  - loads with ``torch`` alone: this module imports nothing of
    ``resnet_tpu_torch`` at its top or in :func:`load_serving`.

Files written: ``<out>.pt2`` (the ``ExportedProgram``; its device count
travels inside it) and ``<out>.json`` (the manifest: model family, depth,
classes, canvas shape, normalize constants, calling convention, torch
version).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

MANIFEST_VERSION = 1
PLATFORMS = ("cpu", "cuda")
# the device count, stored inside the .pt2 beside the program
_DEVICES_FILE = "num_devices"


def _batch_repr(batch_size, num_devices):
    """Manifest spelling of the batch dim: pinned int, or the symbolic
    'b' / 'N*b' (an N-device artifact takes any multiple of N)."""
    if batch_size is not None:
        return int(batch_size)
    return "b" if num_devices == 1 else f"{num_devices}*b"


class ServingModule(torch.nn.Module):
    """uint8 NHWC canvases -> float32 logits: the normalize in float32
    with ``1/std`` taken in float32 (``ops/augment.py::normalize``), the
    cast to the compute dtype, the model. Mean and ``1/std`` are buffers,
    so they move with the module and an export holds them as its own
    tensors, not as constants of one device."""

    def __init__(self, model: torch.nn.Module, mean_rgb, std_rgb,
                 dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.register_buffer(
            "mean", torch.tensor(mean_rgb, dtype=torch.float32))
        self.register_buffer(
            "inv_std", 1.0 / torch.tensor(std_rgb, dtype=torch.float32))

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = ((images_u8.float() - self.mean) * self.inv_std).to(self.dtype)
        return self.model(x).float()


def make_serving_fn(cfg, model: torch.nn.Module) -> ServingModule:
    """The inference module of ``model`` (eval mode: running-statistics
    BatchNorm), on the model's device. It shares the model's parameters
    and puts the model in eval mode; the train step sets train mode again
    at its next call. Call it under ``torch.inference_mode()``."""
    from resnet_tpu_torch.config import DTYPES
    device = next(model.parameters()).device
    serve = ServingModule(model, cfg.data.mean_rgb, cfg.data.std_rgb,
                          DTYPES[cfg.train.dtype]).to(device)
    return serve.eval()


def export_serving(cfg, model: torch.nn.Module, out_prefix: str,
                   batch_size: Optional[int] = None,
                   platforms: Sequence[str] = PLATFORMS,
                   num_devices: int = 1) -> Tuple[str, str]:
    """Export the inference program; returns (artifact_path,
    manifest_path).

    ``batch_size=None`` exports a symbolic batch dimension ``b`` (any
    batch size at call time, 1 included); an int pins it. The program is
    traced from a CPU copy of ``model``, so the file holds CPU tensors and
    loads on any machine; ``platforms`` lists where it may be loaded
    (``cpu``, ``cuda``).

    ``num_devices=N``: the symbolic batch becomes ``N*b`` (any multiple of
    N); a pinned ``batch_size`` must divide by N. The loader then needs N
    cards (or the CPU) and runs one copy per card on blocks of the batch,
    so the program itself takes one block: ``b`` images, or the pinned
    batch over N.
    """
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{list(platforms)}")
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    h, w, c = cfg.data.image_shape
    # the program takes one device's block of the batch: b, or the pinned
    # batch over N
    if batch_size is None:
        dynamic = {"images_u8": {0: torch.export.Dim("b", min=1)}}
        block = 2
    else:
        if batch_size % num_devices:
            raise ValueError(f"batch_size {batch_size} must divide by "
                             f"num_devices {num_devices}")
        dynamic, block = None, batch_size // num_devices
    serve = make_serving_fn(cfg, copy.deepcopy(model).cpu())
    example = torch.zeros((block, h, w, c), dtype=torch.uint8)
    with torch.no_grad():
        exported = torch.export.export(serve, (example,),
                                       dynamic_shapes=dynamic)
    # the file would carry the example batch too: 37 MiB of zeros for a
    # pinned 256-image ImageNet batch
    exported.example_inputs = None

    artifact = out_prefix + ".pt2"
    manifest_path = out_prefix + ".json"
    torch.export.save(exported, artifact,
                      extra_files={_DEVICES_FILE: str(num_devices)})
    shape = _batch_repr(batch_size, num_devices)
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "format": "torch.export ExportedProgram",
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "network": cfg.model.network,
        "depth": cfg.model.depth,
        "version": cfg.model.version,
        "num_classes": cfg.data.num_classes,
        "num_devices": num_devices,
        "sharding": (f"batch dim in {num_devices} equal blocks, one copy "
                     "of the program a device" if num_devices > 1
                     else "replicated (single device)"),
        "input": {
            "shape": [shape, h, w, c],
            "dtype": "uint8",
            "layout": "NHWC",
            "preprocessing": "none (mean/std normalize is inside the "
                             "program); feed raw center-cropped canvases",
        },
        "output": {"shape": [shape, cfg.data.num_classes],
                   "dtype": "float32", "semantics": "logits"},
        "normalize": {"mean_rgb": list(cfg.data.mean_rgb),
                      "std_rgb": list(cfg.data.std_rgb)},
        "compute_dtype": cfg.train.dtype,
    }
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return artifact, manifest_path


def _call_span():
    """The port's ``serve.call`` span (``utils/profiler.py``) where the port
    is loaded; nothing where torch alone is, as this module asks for no
    more."""
    profiler = sys.modules.get("resnet_tpu_torch.utils.profiler")
    return (profiler.span("serve.call") if profiler is not None
            else contextlib.nullcontext())


def load_serving(out_prefix: str, device=None
                 ) -> Tuple[Callable, Dict[str, Any]]:
    """Load an exported artifact; returns (callable, manifest).

    The callable takes a uint8 NHWC tensor (or numpy array) and returns
    float32 logits on the program's device, under
    ``torch.inference_mode``. ``device=None`` means the CUDA card, and
    without one this raises; ``"cpu"`` runs on the CPU. Needs only torch.

    An N-device artifact takes batches that divide by N: on the card it
    places a copy of the program on each of ``cuda:0..N-1`` and runs
    block ``i`` of the batch on card ``i``; on the CPU the N blocks run in
    turn. The logits are concatenated on the first device. A call runs
    inside the ``serve.call`` span where the port is loaded, outside the
    exported program."""
    from torch.export.passes import move_to_device_pass

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to serve on the CPU")
    extra = {_DEVICES_FILE: ""}
    exported = torch.export.load(out_prefix + ".pt2", extra_files=extra)
    n = int(extra[_DEVICES_FILE] or 1)
    manifest = {}
    if os.path.exists(out_prefix + ".json"):
        with open(out_prefix + ".json") as f:
            manifest = json.load(f)
    if device.type not in manifest.get("platforms", PLATFORMS):
        raise ValueError(f"artifact was exported for platforms "
                         f"{manifest['platforms']}, not {device.type}")
    if device.type == "cuda" and n > 1:
        if torch.cuda.device_count() < n:
            raise ValueError(f"artifact was exported for {n} devices; "
                             f"{torch.cuda.device_count()} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [device]
    # the pass moves the program it is given: each further card gets a copy
    programs = [move_to_device_pass(
        copy.deepcopy(exported) if i else exported, d).module()
        for i, d in enumerate(devices)]

    @torch.inference_mode()
    def serve(images_u8):
        with _call_span():
            x = torch.as_tensor(images_u8)
            if x.shape[0] % n:
                raise ValueError(f"batch_size {x.shape[0]} must divide by "
                                 f"num_devices {n}")
            outs = [programs[i % len(programs)](
                block.to(devices[i % len(devices)], non_blocking=True))
                for i, block in enumerate(x.chunk(n))]
            return outs[0] if n == 1 else torch.cat([o.to(devices[0])
                                                     for o in outs])

    return serve, manifest
