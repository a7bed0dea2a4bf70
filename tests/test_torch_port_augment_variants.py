"""The augmentation variants against the JAX package: the CIFAR pad-crop,
the device rotate/shear warp, the split photometric path
(``augment_impl="pallas-split"``) and the host warp of the record
pipeline.

Randomness crosses as values: each test draws with the JAX package's own
samplers and keys and feeds the draws to the port as its per-image rows.
Tolerances: the CIFAR crop at 1e-5 (one float32 ulp of ``1/std`` apart,
``ops/augment.py::finish_normalize``); the warp at 1e-4 (the same
gather and bilinear weights in float32); paths with the HSL jitter at the
fused kernel's bar, atol 5e-2 / rtol 1e-4 (tests/test_pallas_augment.py),
since a float32 ulp can flip a hue sector on a near-grey pixel. The host
warp and the record stream are held byte for byte.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.config import DataConfig as JaxDataConfig
from resnet_tpu.data import host_warp as jax_host_warp
from resnet_tpu.data.pipeline import RecordIter as JaxRecordIter
from resnet_tpu.ops import augment as jax_augment
from resnet_tpu.ops.augment_pallas import (
    augment_imagenet_pallas, sample_photometric as jax_sample_photometric)
from resnet_tpu_torch import config
from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.data import host_warp
from resnet_tpu_torch.data.pipeline import RecordIter
from resnet_tpu_torch.ops import augment
from resnet_tpu_torch.ops.augment_fused import (augment_imagenet_fused,
                                                augment_rows, make_augment_fn)
from resnet_tpu_torch.train.solver import _eval_fn, device_augment_config
from test_torch_port_data import _assert_streams_equal, _cfgs, pack  # noqa

N, HC, WC, OUT = 4, 40, 48, (32, 32)
MEAN, STD = DataConfig().mean_rgb, DataConfig().std_rgb
DIMS = np.array([[100, 200, 20, 40], [80, 96, 40, 48], [300, 150, 40, 20],
                 [40, 48, 40, 48]], np.int32)


def _canvas(seed, n=N, h=HC, w=WC):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


# ---------------------------------------------------------------------------
# CIFAR
# ---------------------------------------------------------------------------

def _jax_cifar_rows(key, cfg, n):
    """The values ``augment_cifar`` draws from ``key``, as the port's
    (N, 5) rows: dy, dx, flip, alpha, beta."""
    pad = int(cfg.pad)
    r_crop, r_mirror = jax.random.split(key)
    dy = jax.random.randint(r_crop, (n,), 0, 2 * pad + 1)
    dx = jax.random.randint(jax.random.fold_in(r_crop, 1), (n,), 0,
                            2 * pad + 1)
    flip = (jax.random.bernoulli(r_mirror, 0.5, (n,)) if cfg.rand_mirror
            else jnp.zeros((n,), bool))
    r_con, r_ill = jax.random.split(jax.random.fold_in(key, 0xC1))
    c, il = cfg.max_random_contrast, cfg.max_random_illumination
    alpha = (jax.random.uniform(r_con, (n, 1, 1, 1), minval=1.0 - c,
                                maxval=1.0 + c).reshape(n) if c > 0
             else jnp.ones((n,)))
    beta = (jax.random.uniform(r_ill, (n, 1, 1, 1), minval=-il,
                               maxval=il).reshape(n) if il > 0
            else jnp.zeros((n,)))
    return torch.from_numpy(np.stack(
        [np.asarray(v, np.float32) for v in (dy, dx, flip, alpha, beta)], 1))


@pytest.mark.parametrize("data", [
    {}, dict(pad=2, fill_value=128, max_random_contrast=0.3,
             max_random_illumination=20.0), dict(rand_mirror=False)],
    ids=["preset", "pad2_fill_jitter", "no_mirror"])
def test_augment_cifar_matches_jax(data):
    jcfg = dataclasses.replace(config.cifar10_resnet18().data, **data)
    images = _canvas(3, n=8, h=32, w=32)
    key = jax.random.key(7)
    want = np.asarray(jax_augment.augment_cifar(
        jnp.asarray(images), key,
        JaxDataConfig(**dataclasses.asdict(jcfg)), jnp.float32))
    rows = _jax_cifar_rows(key, jcfg, 8)
    got = augment.augment_cifar(torch.from_numpy(images), None, jcfg,
                                rows=rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own draws are in range
    own = augment.sample_cifar_rows(torch.Generator().manual_seed(0), jcfg,
                                    256)
    pad = int(jcfg.pad)
    assert own[:, :2].min() >= 0 and own[:, :2].max() <= 2 * pad
    assert set(own[:, 2].tolist()) <= {0.0, 1.0}


def test_cifar_preset_routes_to_augment_cifar_and_normalize():
    cfg = config.cifar10_resnet18()
    images = torch.from_numpy(_canvas(4, n=4, h=32, w=32))
    rows = augment.sample_cifar_rows(torch.Generator().manual_seed(1),
                                     cfg.data, 4)
    got = make_augment_fn(cfg)(images, None, rows=rows)
    want = augment.augment_cifar(images, None, cfg.data, rows=rows)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        _eval_fn(cfg)(images),
        augment.normalize(images, cfg.data.mean_rgb, cfg.data.std_rgb),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the device rotate/shear warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_images_matches_jax(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (N, 20, 24, 3)).astype(np.float32)
    angles = rng.uniform(-0.6, 0.6, N).astype(np.float32)
    shears = rng.uniform(-0.3, 0.3, N).astype(np.float32)
    want = np.asarray(jax_augment.rotate_images(
        jnp.asarray(images), jax.random.key(0), 0.0, 0.0,
        angles=jnp.asarray(angles), shears=jnp.asarray(shears)))
    got = augment.rotate_images(torch.from_numpy(images),
                                torch.from_numpy(angles),
                                torch.from_numpy(shears)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _jax_rows(key, jcfg, dims, n=N, rotate=False):
    """The (N, 12) rows of the JAX augmenter's draws from ``key`` and the
    warp's (angles, shears): ``augment_imagenet``'s 4-way split with
    ``rotate``, else ``augment_imagenet_pallas``'s 3-way one and no
    warp."""
    keys = jax.random.split(key, 4 if rotate else 3)
    r_box, r_mir, r_hsl = keys[:3]
    boxes = jax_augment.sample_boxes_canvas(r_box, jcfg, n, HC, WC, OUT,
                                            jnp.asarray(dims))
    flip = jax.random.bernoulli(r_mir, 0.5, (n,)).astype(jnp.float32)
    ph = jax_sample_photometric(key, r_hsl, jcfg, n)
    warp = None
    if rotate:
        r_a, r_s = jax.random.split(keys[3])
        warp = [torch.from_numpy(np.array(v, np.float32)) for v in (
            jax.random.uniform(r_a, (n,), minval=-jcfg.max_rotate_angle,
                               maxval=jcfg.max_rotate_angle) * (np.pi / 180),
            jax.random.uniform(r_s, (n,), minval=-jcfg.max_shear_ratio,
                               maxval=jcfg.max_shear_ratio))]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return augment_rows([t(b) for b in boxes], t(flip),
                        (t(dims[:, 2]), t(dims[:, 3])),
                        {k: t(v) for k, v in ph.items()}, n,
                        (HC, WC)), warp


@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_rotate_augmenter_matches_jax(s2d):
    """The whole device-warp augmenter (warp, crop, mirror, HSL,
    normalize) fed the JAX draws, against ``augment_imagenet``; the JAX
    Pallas drop-in routes this variant to the same path."""
    data = dict(max_rotate_angle=15.0, max_shear_ratio=0.2,
                rotate_backend="device")
    jcfg = JaxDataConfig(**data)
    canvas = _canvas(5)
    key = jax.random.key(11)
    want = np.asarray(augment_imagenet_pallas(
        jnp.asarray(canvas), key, jcfg, OUT, jnp.float32, interpret=True,
        dims=jnp.asarray(DIMS), s2d=s2d))
    rows, warp = _jax_rows(key, jcfg, DIMS, rotate=True)
    got = augment_imagenet_fused(torch.from_numpy(canvas), None,
                                 DataConfig(**data), OUT, torch.float32,
                                 s2d=s2d, rows=rows, warp=warp).numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-4)
    # the port's own draws: angles within the range, in radians
    cfg = DataConfig(**data)
    own = make_augment_fn(dataclasses.replace(
        config.Config(), data=dataclasses.replace(cfg, image_shape=(32, 32,
                                                                    3))))
    out = own(torch.from_numpy(canvas), torch.Generator().manual_seed(0),
              torch.from_numpy(DIMS))
    assert out.shape == (N, 32, 32, 3) and torch.isfinite(out).all()
    angles, shears = augment.sample_rotate(torch.Generator().manual_seed(0),
                                           cfg, 512)
    assert angles.abs().max() <= np.radians(15.0) + 1e-6
    assert shears.abs().max() <= 0.2 + 1e-6


# ---------------------------------------------------------------------------
# the split photometric path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [
    {}, dict(max_random_contrast=0.3, max_random_illumination=20.0),
    dict(random_h=0, random_s=0, random_l=0)],
    ids=["hsl", "hsl_contrast_illum", "no_photometric"])
@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_split_path_matches_jax_split(s2d, data):
    """``augment_impl="pallas-split"``: the kernel crops with identity
    normalization, the jitter and normalize follow, against the JAX
    ``augment_imagenet_pallas(split_photometric=True)``; and against the
    port's fused path on the same rows."""
    jcfg = JaxDataConfig(**data)
    canvas = _canvas(6)
    key = jax.random.key(23)
    want = np.asarray(augment_imagenet_pallas(
        jnp.asarray(canvas), key, jcfg, OUT, jnp.float32, interpret=True,
        dims=jnp.asarray(DIMS), split_photometric=True, s2d=s2d))
    rows, _ = _jax_rows(key, jcfg, DIMS)
    cfg = DataConfig(**data)
    run = lambda split: augment_imagenet_fused(
        torch.from_numpy(canvas), None, cfg, OUT, torch.float32, s2d=s2d,
        rows=rows, split=split).numpy()
    got = run(True)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-4)
    np.testing.assert_allclose(got, run(False), atol=5e-2, rtol=1e-4)


# ---------------------------------------------------------------------------
# the host warp and the record pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_idx", [0, 3])
def test_host_warp_matches_jax_byte_for_byte(batch_idx):
    images = _canvas(8, n=6, h=36, w=30)
    want_p = jax_host_warp.batch_params(5, 2, batch_idx, 6, 12.0, 0.15)
    got_p = host_warp.batch_params(5, 2, batch_idx, 6, 12.0, 0.15)
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g, w)
    want = jax_host_warp.warp_batch(images, *want_p)
    with ThreadPoolExecutor(2) as pool:
        got = host_warp.warp_batch(images, *got_p, pool=pool)
    assert got.dtype == np.uint8 and got.shape == images.shape
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, images)


def test_record_host_warp_stream_and_resume(pack):  # noqa: F811
    """The record pipeline with the host warp on: both packages' train
    streams equal byte for byte, and a mid-epoch resume replays the
    port's; the Solver then zeroes the device warp (only there)."""
    warp = dict(max_rotate_angle=20.0, max_shear_ratio=0.1)
    jcfg, cfg = _cfgs(pack, **warp)
    full = list(RecordIter(cfg, train=True).epoch_iter(1))
    _assert_streams_equal(full, JaxRecordIter(jcfg, train=True).epoch_iter(1))
    plain = list(RecordIter(_cfgs(pack)[1], train=True).epoch_iter(1))
    assert not np.array_equal(full[0]["image"], plain[0]["image"])
    it = RecordIter(cfg, train=True)
    gen = it.epoch_iter(1)
    head = [next(gen) for _ in range(2)]
    cursor = it.cursor_state(2)
    gen.close()
    resumed = RecordIter(cfg, train=True)
    resumed.load_state_dict(cursor)
    _assert_streams_equal(head + list(resumed.epoch_iter(1)), full)

    cfg.data.pipeline = "record"
    dev = device_augment_config(cfg).data
    assert dev.max_rotate_angle == dev.max_shear_ratio == 0.0
    for other in (dataclasses.replace(cfg.data, pipeline="memory"),
                  dataclasses.replace(cfg.data, rotate_backend="device")):
        kept = device_augment_config(cfg.replace(data=other)).data
        assert kept.max_rotate_angle == 20.0 and kept.max_shear_ratio == 0.1
