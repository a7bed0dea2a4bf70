"""Tests of the port that need the CUDA card; each skips without one.

They import nothing of JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The kernel is held against its plain PyTorch version (itself held against
the JAX kernel by tests/test_torch_port_augment.py), and the card's
max-pool backward against the CPU's tie routing.
"""

import pytest
import torch

from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.ops.augment import space_to_depth
from resnet_tpu_torch.ops.augment_fused import (
    augment_rows, fused_crop_mirror_normalize,
    fused_crop_mirror_normalize_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from resnet_tpu_torch.utils.device import set_tf32
    set_tf32(False)
    yield torch.device("cuda")
    set_tf32(True)


def _inputs(device, n=5, hc=40, wc=48):
    g = torch.Generator().manual_seed(0)
    canvas = torch.randint(0, 256, (n, hc, wc, 3), generator=g,
                           dtype=torch.uint8)
    vh = torch.tensor([40.0, 23.0, 40.0, 31.0, 40.0][:n])
    vw = torch.tensor([48.0, 48.0, 17.0, 29.0, 48.0][:n])
    ch = torch.round(4 + torch.rand(n, generator=g) * (vh - 4))
    cw = torch.round(4 + torch.rand(n, generator=g) * (vw - 4))
    y0 = torch.floor(torch.rand(n, generator=g) * (vh - ch + 1))
    x0 = torch.floor(torch.rand(n, generator=g) * (vw - cw + 1))
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    ph = {"dh": u(-36, 36), "ds": u(-50, 50), "dl": u(-50, 50),
          "alpha": u(0.7, 1.3), "beta": u(-20, 20)}
    rows = augment_rows((y0, x0, ch, cw), torch.rand(n, generator=g) < 0.5,
                        (vh, vw), ph, n, (hc, wc))
    return canvas.to(device), rows.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_kernel_matches_plain_version(cuda, s2d, dtype):
    canvas, rows = _inputs(cuda)
    d = DataConfig()
    args = (canvas, rows, (32, 32), d.mean_rgb, d.std_rgb, dtype)
    flags = dict(s2d=s2d, hsl=True, contrast=True, illum=True)
    before = fused_crop_mirror_normalize.launches
    got = fused_crop_mirror_normalize(*args, **flags)
    want = fused_crop_mirror_normalize_reference(*args, **flags)
    torch.cuda.synchronize()
    assert fused_crop_mirror_normalize.launches == before + 1
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                               rtol=rtol)
    if s2d:
        std = fused_crop_mirror_normalize(*args, **dict(flags, s2d=False))
        assert torch.equal(got, space_to_depth(std))


def test_kernel_rejects_bad_input(cuda):
    canvas, rows = _inputs(cuda)
    d = DataConfig()
    with pytest.raises(ValueError):
        fused_crop_mirror_normalize(canvas[:, :, ::2], rows, (32, 32),
                                    d.mean_rgb, d.std_rgb)
    with pytest.raises(ValueError):
        fused_crop_mirror_normalize(canvas, rows[:, :11], (32, 32),
                                    d.mean_rgb, d.std_rgb)


def test_pool_backward_ties_match_cpu(cuda):
    from resnet_tpu_torch.ops.pool import stem_max_pool
    g = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(2, 4, 9, 10, generator=g))
    x[0, :, :4, :4] = 0.5
    dy = torch.randn(2, 4, 5, 5, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        stem_max_pool(xd).backward(dy.to(dev))
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_train_step_launches_the_kernel(cuda):
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.resnet import ResNet
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    cfg = imagenet_resnet50()
    cfg.data.image_shape = (32, 32, 3)
    model = ResNet(units=(1, 1, 1, 1), filters=(8, 16, 32, 64, 128),
                   num_classes=1000, bottleneck=True, bn_ema=True,
                   stem_s2d=True, dtype=torch.bfloat16)
    state = create_train_state(cfg, device=cuda, model=model)
    step = make_train_step(augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=2)
    batch = {"image": torch.randint(0, 256, (2, 4, 40, 48, 3),
                                    dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 1000, (2, 4), device=cuda)}
    before = fused_crop_mirror_normalize.launches
    state, m = step(state, batch)
    assert fused_crop_mirror_normalize.launches == before + 2
    assert state.step == 2 and float(m["count"]) == 8
    assert torch.isfinite(m["loss_sum"])
