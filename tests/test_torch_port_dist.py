"""The port's multi-process pieces: the sharded iterators against the JAX
package's, the replica layout against JAX's ``NamedSharding``, the global
batch's augmentation draw, the launcher, the entry point over 2 gloo ranks
(train, checkpoint from rank 0 only, resume) and ``dryrun_multichip(2)``.

Every spawned process runs under a timeout of its own: a hung collective
kills its ranks and fails the test.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.data import im2rec as jax_im2rec
from resnet_tpu.data.loader import make_train_iter as jax_make_train_iter
from resnet_tpu.data.loader import make_val_iter as jax_make_val_iter
from resnet_tpu.data.pipeline import RecordIter as JaxRecordIter
from resnet_tpu.parallel.mesh import (batch_sharded, make_mesh,
                                      stacked_batch_sharded)
from resnet_tpu_torch.config import Config, ENV_COORD, require_ported
from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
from resnet_tpu_torch.data.pipeline import RecordIter
from resnet_tpu_torch.ops.augment import augment_cifar
from resnet_tpu_torch.ops.augment_fused import augment_imagenet_fused
from resnet_tpu_torch.parallel.mesh import check_num_devices, shard_batch
from resnet_tpu_torch.tools.launch import free_port, start, wait_all
from resnet_tpu_torch.train.steps import step_generator

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARTS = 2


def _assert_streams_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x) == set(y), i
        for k in x:
            assert x[k].dtype == y[k].dtype, (i, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """20 JPEGs of four sizes in one .rec, packed by the JAX im2rec."""
    root = tmp_path_factory.mktemp("pack")
    rng = np.random.default_rng(5)
    sizes = [(40, 56), (64, 48), (30, 30), (72, 40)]
    for i in range(20):
        d = root / f"class_{i % 3}"
        d.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, sizes[i % 4] + (3,), np.uint8)
                        ).save(d / f"im{i:02d}.jpg", quality=90)
    prefix = str(root / "train")
    jax_im2rec.pack(str(root), prefix, jax_im2rec.build_list(str(root)))
    return str(root)


def _cfgs(pipeline, data_dir="data"):
    out = []
    for cfg in (JaxConfig(), Config()):
        d = cfg.data
        d.pipeline, d.data_dir, d.train_rec, d.val_rec = \
            pipeline, data_dir, "train.rec", "train.rec"
        d.train_idx = d.val_idx = "train.idx"
        d.image_shape, d.num_examples, d.num_classes = (32, 32, 3), 45, 10
        d.preprocess_threads = 2
        cfg.train.batch_size, cfg.train.seed = 6, 3
        out.append(cfg)
    return out


@pytest.mark.parametrize("part", range(PARTS))
@pytest.mark.parametrize("pipeline", ["memory", "synthetic", "record"])
def test_sharded_iterators_match_jax_byte_for_byte(pack, pipeline, part):
    jcfg, cfg = _cfgs(pipeline, pack)
    it = make_train_iter(cfg, PARTS, part)
    jit = jax_make_train_iter(jcfg, PARTS, part)
    assert it.batch_size == jit.batch_size == 3
    assert it.steps_per_epoch == jit.steps_per_epoch
    for epoch in (0, 1):
        _assert_streams_equal(it.epoch_iter(epoch), jit.epoch_iter(epoch))
    val, jval = make_val_iter(cfg, PARTS, part), \
        jax_make_val_iter(jcfg, PARTS, part)
    assert (val is None) == (jval is None)
    if val is not None:
        batches = list(val.epoch_iter(0))
        _assert_streams_equal(batches, jval.epoch_iter(0))
        assert all("mask" in b for b in batches)


def test_record_parts_are_disjoint_and_cover_the_pack(pack):
    _, cfg = _cfgs("record", pack)
    seen = []
    for part in range(PARTS):
        it = RecordIter(cfg, train=False, num_parts=PARTS, part_index=part)
        for b in it.epoch_iter(0):
            seen += [img.tobytes() for img, m in zip(b["image"], b["mask"])
                     if m]
    assert len(seen) == len(set(seen)) == 20


@pytest.mark.parametrize("stacked", [False, True])
def test_replica_blocks_are_the_jax_mesh_shards(stacked):
    rng = np.random.default_rng(0)
    shape = (3, 8, 5) if stacked else (8, 5)
    x = rng.normal(size=shape).astype(np.float32)
    mesh = make_mesh(PARTS)
    sharded = jax.device_put(x, stacked_batch_sharded(mesh) if stacked
                             else batch_sharded(mesh))
    shards = sorted(sharded.addressable_shards,
                    key=lambda s: mesh.devices.tolist().index(s.device))
    for rank, shard in enumerate(shards):
        got = shard_batch({"x": torch.from_numpy(x)}, rank, PARTS,
                          stacked=stacked)["x"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_num_devices_is_zero_or_the_world_size():
    assert check_num_devices(0, 4) == 4 and check_num_devices(4, 4) == 4
    with pytest.raises(ValueError, match="requested 8 devices"):
        check_num_devices(8, 4)
    with pytest.raises(ValueError, match="not divisible by 3"):
        shard_batch({"x": torch.zeros(8)}, 0, 3)


def test_more_than_one_device_needs_the_launcher(monkeypatch):
    cfg = Config()
    cfg.train.num_devices = 2
    monkeypatch.delenv(ENV_COORD, raising=False)
    with pytest.raises(ValueError, match="resnet_tpu_torch.tools.launch -n 2"):
        require_ported(cfg)
    monkeypatch.setenv(ENV_COORD, "127.0.0.1:1")
    require_ported(cfg)


@pytest.mark.parametrize("rank", range(PARTS))
def test_global_draw_gives_each_rank_its_block_of_the_batch(rank):
    """Under jit every rank draws the global batch's values and keeps its
    block: the same images as augmenting the global batch in one process,
    with per-image letterbox dims that differ between the ranks."""
    rng = np.random.default_rng(1)
    n = 6
    canvas = torch.from_numpy(rng.integers(0, 256, (n, 40, 48, 3), np.uint8))
    dims = torch.tensor([[80, 96, 40, 48], [100, 50, 40, 20], [40, 48, 40, 48],
                         [60, 60, 40, 40], [30, 90, 16, 48], [48, 40, 40, 33]],
                        dtype=torch.int32)
    d = Config().data
    d.random_h, d.random_s, d.random_l = 20, 30, 30
    d.max_rotate_angle, d.rotate_backend = 10.0, "device"
    block = slice(rank * n // PARTS, (rank + 1) * n // PARTS)
    gen = lambda: torch.Generator().manual_seed(9)
    want = augment_imagenet_fused(canvas, gen(), d, (32, 32), torch.float32,
                                  dims=dims, plain=True)[block]
    got = augment_imagenet_fused(canvas[block], gen(), d, (32, 32),
                                 torch.float32, dims=dims[block], plain=True,
                                 replica=(rank, PARTS))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    images = canvas[:, :32, :32]
    want = augment_cifar(images, gen(), d)[block]
    got = augment_cifar(images[block], gen(), d, replica=(rank, PARTS))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_step_generator_folds_the_rank():
    """Each rank its own stream; rank 0's is the one-device stream (the
    seed sequence pads its entropy with zeros)."""
    draw = lambda g: torch.rand(4, generator=g)
    one = draw(step_generator(0, 5, "cpu"))
    ranks = [draw(step_generator(0, 5, "cpu", rank=r)) for r in range(3)]
    assert torch.equal(one, ranks[0])
    assert not torch.equal(ranks[0], ranks[1])
    assert not torch.equal(ranks[1], ranks[2])
    assert not torch.equal(one, draw(step_generator(0, 6, "cpu")))


def test_launcher_fails_fast_and_kills_the_other_ranks(tmp_path):
    """Rank 1 exits 3 while rank 0 would sleep a minute: the launcher
    terminates rank 0 and returns 3 at once."""
    prog = ("import os, sys, time\n"
            "if os.environ['RESNET_TPU_PROC_ID'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    tic = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "resnet_tpu_torch.tools.launch", "-n", "2",
         "--coordinator", f"127.0.0.1:{free_port()}", "--",
         sys.executable, "-c", prog], cwd=ROOT, timeout=60,
        capture_output=True, text=True)
    assert proc.returncode == 3, proc.stderr
    assert time.monotonic() - tic < 30
    assert "terminating remaining workers" in proc.stderr


def test_wait_all_kills_ranks_past_the_timeout():
    procs = start([sys.executable, "-c", "import time; time.sleep(60)"], 2,
                  "127.0.0.1:1")
    with pytest.raises(TimeoutError, match="2 of 2 ranks"):
        wait_all(procs, timeout=1.0)
    assert all(p.poll() is not None for p in procs)


# the entry point, each rank's checkpoint writes logged and its final state
# saved: python -c CLI_RANK <log> <train_resnet args>
CLI_RANK = """
import os, sys, torch
from resnet_tpu_torch import train_resnet
from resnet_tpu_torch.train import checkpoint
rank, log = os.environ["RESNET_TPU_PROC_ID"], sys.argv[1]
save = checkpoint.save_checkpoint
def logged(prefix, epoch, state, **kw):
    with open(log, "a") as f:
        f.write(f"{rank} {epoch}\\n")
    return save(prefix, epoch, state, **kw)
checkpoint.save_checkpoint = logged
state = train_resnet.main(sys.argv[2:])
torch.save({"model": state.model.state_dict(), "momentum": state.momentum,
            "step": state.step}, f"{log}.rank{rank}.pt")
"""


def _cli(tmp_path, *extra):
    log = tmp_path / "saves.log"
    args = ["--device", "cpu", "--preset", "cifar10_resnet18", "--depth", "8",
            "--image-shape", "16,16,3", "--pipeline", "synthetic",
            "--num-examples", "64", "--batch-size", "16", "--frequent", "2",
            "--num-devices", "2", "--model-prefix", str(tmp_path / "ck"),
            *extra]
    out = tmp_path / "out.log"
    with open(out, "w") as f:
        procs = start([sys.executable, "-c", CLI_RANK, str(log), *args], 2,
                      f"127.0.0.1:{free_port()}", cwd=ROOT, stdout=f,
                      stderr=subprocess.STDOUT,
                      env=dict(os.environ, OMP_NUM_THREADS="2"))
        rc = wait_all(procs, timeout=180)
    text = out.read_text()
    assert rc == 0, text[-4000:]
    return text, log


def test_two_ranks_train_checkpoint_from_rank_0_and_resume(tmp_path):
    out, log = _cli(tmp_path, "--num-epochs", "1")
    assert log.read_text().split("\n")[:-1] == ["0 1"]
    assert (tmp_path / "ck" / "1.pt").exists()
    assert "Epoch[0] Batch [4]" in out and "samples/sec" in out
    out, _ = _cli(tmp_path, "--num-epochs", "2", "--auto-resume")
    assert log.read_text().split("\n")[:-1] == ["0 1", "0 2"]
    assert "Resumed from epoch 1 (step 4)" in out
    a, b = (torch.load(f"{log}.rank{r}.pt", weights_only=True)
            for r in range(2))
    assert a["step"] == b["step"] == 8
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)


def test_dryrun_multichip_needs_a_card_a_rank():
    from resnet_tpu_torch.dryrun import dryrun_multichip
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices"):
        dryrun_multichip(n)


def test_dryrun_multichip_two_ranks(capfd, monkeypatch):
    from resnet_tpu_torch.dryrun import dryrun_multichip
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    dryrun_multichip(2, device="cpu", timeout_s=300)
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("dryrun_multichip ok")]
    assert len(lines) == 7, lines
    assert all("2 ranks, gloo" in line for line in lines)
