"""The port's augmentation against the JAX package's.

The plain version of the fused augmentation kernel
(``resnet_tpu_torch.ops.augment_fused``) is held against the JAX Pallas
kernel run in interpret mode, on the same canvases and the same per-image
rows, made with numpy from a seed. Tolerances: atol 1e-3 without HSL (two
dense products in float32 on values of order 1); atol 5e-2 / rtol 1e-4
with HSL, the bar the JAX package holds its own kernel to
(tests/test_pallas_augment.py), since a float32 ulp can flip a hue sector
or the ``cmax == r`` tie on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.config import DataConfig as JaxDataConfig
from resnet_tpu.ops import augment as jax_augment
from resnet_tpu.ops.augment_pallas import (
    augment_imagenet_pallas, fused_crop_mirror_normalize as jax_fused,
    sample_photometric as jax_sample_photometric)
from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.ops import augment
from resnet_tpu_torch.ops.augment_fused import (
    augment_imagenet_fused, augment_rows, fused_crop_mirror_normalize)

MEAN, STD = DataConfig().mean_rgb, DataConfig().std_rgb
N, HC, WC, OUT = 3, 40, 48, (32, 32)


def _case(seed, letterbox, photometric):
    """numpy canvases and the per-image values of one case."""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (N, HC, WC, 3), np.uint8)
    if letterbox:
        vh = np.array([20.0, 40.0, 33.0], np.float32)
        vw = np.array([48.0, 17.0, 29.0], np.float32)
        for i in range(N):   # letterboxed content top-left, zero pad beyond
            canvas[i, int(vh[i]):] = 0
            canvas[i, :, int(vw[i]):] = 0
    else:
        vh = np.full(N, HC, np.float32)
        vw = np.full(N, WC, np.float32)
    ch = np.round(rng.uniform(4, vh)).astype(np.float32)
    cw = np.round(rng.uniform(4, vw)).astype(np.float32)
    y0 = np.floor(rng.uniform(0, vh - ch + 1)).astype(np.float32)
    x0 = np.floor(rng.uniform(0, vw - cw + 1)).astype(np.float32)
    flip = np.array([1.0, 0.0, 1.0], np.float32)
    ph = {}
    if photometric in ("hsl", "all"):
        ph["dh"] = rng.uniform(-36, 36, N).astype(np.float32)
        ph["ds"] = rng.uniform(-50, 50, N).astype(np.float32)
        ph["dl"] = rng.uniform(-50, 50, N).astype(np.float32)
    if photometric == "all":
        ph["alpha"] = rng.uniform(0.7, 1.3, N).astype(np.float32)
        ph["beta"] = rng.uniform(-20, 20, N).astype(np.float32)
    return canvas, (y0, x0, ch, cw), flip, (vh, vw), ph


def _port_rows(boxes, flip, valid, ph):
    t = lambda a: torch.from_numpy(np.array(a))
    return augment_rows([t(b) for b in boxes], t(flip),
                        [t(v) for v in valid],
                        {k: t(v) for k, v in ph.items()}, N, (HC, WC))


def _port(canvas, boxes, flip, valid, ph, s2d):
    return fused_crop_mirror_normalize(
        torch.from_numpy(canvas), _port_rows(boxes, flip, valid, ph), OUT,
        MEAN, STD, torch.float32, s2d=s2d, hsl="dh" in ph,
        contrast="alpha" in ph, illum="beta" in ph).numpy()


@pytest.mark.parametrize("letterbox", [False, True],
                         ids=["full", "letterbox"])
@pytest.mark.parametrize("photometric", ["none", "hsl", "all"])
@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_plain_version_matches_pallas_kernel(s2d, photometric, letterbox):
    canvas, boxes, flip, valid, ph = _case(11, letterbox, photometric)
    want = np.asarray(jax_fused(
        jnp.asarray(canvas), tuple(jnp.asarray(b) for b in boxes),
        jnp.asarray(flip), OUT, MEAN, STD, jnp.float32, interpret=True,
        valid_hw=tuple(jnp.asarray(v) for v in valid),
        photometric={k: jnp.asarray(v) for k, v in ph.items()} or None,
        s2d=s2d))
    got = _port(canvas, boxes, flip, valid, ph, s2d)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    print(f"max abs diff {err:.3g}")
    if photometric == "none":
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-4)


def test_s2d_is_bitwise_regroup_of_standard():
    canvas, boxes, flip, valid, ph = _case(12, True, "all")
    std = _port(canvas, boxes, flip, valid, ph, s2d=False)
    s2d = _port(canvas, boxes, flip, valid, ph, s2d=True)
    assert s2d.shape == (N, OUT[0] // 2, OUT[1] // 2, 12)
    n, h, w, c = std.shape
    regrouped = (std.reshape(n, h // 2, 2, w // 2, 2, c)
                 .transpose(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 12))
    np.testing.assert_array_equal(s2d, regrouped)


def test_boxes_from_uniforms_matches_jax_exactly():
    rng = np.random.default_rng(3)
    n, a = 64, 10
    u = [rng.random((n, a), dtype=np.float32) for _ in range(4)]
    src_h = rng.integers(20, 400, n).astype(np.float32)
    src_w = rng.integers(20, 400, n).astype(np.float32)
    args = (0.08, 1.0, 0.75, 1.25)
    want = jax_augment.boxes_from_uniforms(
        *map(jnp.asarray, u), jnp.asarray(src_h), jnp.asarray(src_w), *args)
    got = augment.boxes_from_uniforms(
        *map(torch.from_numpy, u), torch.from_numpy(src_h),
        torch.from_numpy(src_w), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_augment_imagenet_fused_matches_pallas_drop_in(s2d):
    """Fed the rows the JAX samplers drew (the split of
    augment_imagenet_pallas), the port's augmenter gives the JAX one's
    output."""
    rng = np.random.default_rng(5)
    canvas = rng.integers(0, 256, (N, HC, WC, 3), np.uint8)
    dims = np.array([[100, 200, 20, 40], [80, 96, 40, 48],
                     [300, 150, 40, 20]], np.int32)
    jcfg = JaxDataConfig()
    key = jax.random.key(29)
    want = np.asarray(augment_imagenet_pallas(
        jnp.asarray(canvas), key, jcfg, OUT, jnp.float32, interpret=True,
        dims=jnp.asarray(dims), s2d=s2d))

    r_box, r_mir, r_hsl = jax.random.split(key, 3)
    boxes = jax_augment.sample_boxes_canvas(r_box, jcfg, N, HC, WC, OUT,
                                            jnp.asarray(dims))
    flip = jax.random.bernoulli(r_mir, 0.5, (N,)).astype(jnp.float32)
    ph = jax_sample_photometric(key, r_hsl, jcfg, N)
    valid = (dims[:, 2].astype(np.float32), dims[:, 3].astype(np.float32))
    rows = _port_rows([np.asarray(b) for b in boxes], np.asarray(flip),
                      valid, {k: np.asarray(v) for k, v in ph.items()})
    got = augment_imagenet_fused(torch.from_numpy(canvas), None,
                                 DataConfig(), OUT, torch.float32,
                                 s2d=s2d, rows=rows).numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-4)


def test_sampled_rows_are_valid_boxes():
    """The port's own samplers (generator in) give integer-origin boxes
    inside the letterboxed extent, p=0.5 flips and in-range jitter."""
    cfg = DataConfig()
    n = 256
    dims = torch.tensor([[300, 200, 256, 171]] * n, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    y0, x0, ch, cw = augment.sample_boxes_canvas(g, cfg, n, 256, 256,
                                                 (224, 224), dims)
    assert torch.all(y0 >= 0) and torch.all(y0 + ch <= 256 + 1e-3)
    assert torch.all(x0 >= 0) and torch.all(x0 + cw <= 171 + 1e-3)
    area = (ch / 256 * 300) * (cw / 171 * 200) / (300 * 200)
    assert area.min() >= 0.08 - 0.02 and area.max() <= 1.0 + 1e-6
    from resnet_tpu_torch.ops.augment_fused import sample_photometric
    ph = sample_photometric(g, cfg, n)
    assert ph["dh"].abs().max() <= 36 and ph["ds"].abs().max() <= 50
    assert set(ph) == {"dh", "ds", "dl"}
