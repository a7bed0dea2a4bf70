"""The port's data layer against the JAX package's: RecordIO framing, the
record pipeline (native decode pool and letterbox canvases), the
in-memory and synthetic iterators, and the grouped prefetch.

The pack is 48 JPEGs of several sizes and aspects (so the letterbox
``dims`` differ), made from a numpy seed and written with the JAX
package's ``im2rec`` into two shards, plus one corrupt record. Both
packages read it through their own ``RecordIter`` (each builds its own
copy of the C++ decode pool): two shuffled train epochs and one padded
val epoch must be equal byte for byte (images, labels, dims, masks), and
so must the stream replayed after a mid-epoch ``cursor_state`` ->
``load_state_dict``. Exact equality is the bar throughout: nothing here
is floating-point arithmetic that the two sides order differently.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.data import im2rec as jax_im2rec
from resnet_tpu.data import recordio as jax_recordio
from resnet_tpu.data.loader import MemoryIter as JaxMemoryIter
from resnet_tpu.data.loader import SyntheticIter as JaxSyntheticIter
from resnet_tpu.data.loader import make_train_iter as jax_make_train_iter
from resnet_tpu.data.loader import make_val_iter as jax_make_val_iter
from resnet_tpu.data.loader import synthetic_cifar as jax_synthetic_cifar
from resnet_tpu.data.pipeline import RecordIter as JaxRecordIter
from resnet_tpu.data.prefetch import prefetch_grouped as jax_prefetch_grouped
from resnet_tpu_torch.config import Config
from resnet_tpu_torch.data import recordio
from resnet_tpu_torch.data.loader import (MemoryIter, SyntheticIter,
                                          make_train_iter, make_val_iter,
                                          synthetic_cifar)
from resnet_tpu_torch.data.native import (NativeRecordLoader,
                                          PythonRecordLoader, ensure_built)
from resnet_tpu_torch.data.pipeline import RecordIter, resolve_shards
from resnet_tpu_torch.data.prefetch import prefetch_grouped

N_IMAGES, BATCH = 48, 10
SIZES = [(40, 56), (64, 48), (30, 30), (72, 40), (50, 90), (36, 44)]


def _append_corrupt(rec_path, idx_path, key):
    """One more record whose payload is not an image."""
    one = rec_path + ".one"
    with jax_recordio.RecordIOWriter(one) as w:
        w.write(jax_recordio.pack_image_record(b"\xff\xd8 not a jpeg", 2.0,
                                               rec_id=key))
    offset = os.path.getsize(rec_path)
    with open(rec_path, "ab") as f, open(one, "rb") as g:
        f.write(g.read())
    with open(idx_path, "a") as f:
        f.write(f"{key}\t{offset}\n")
    os.remove(one)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    rng = np.random.default_rng(3)
    for i in range(N_IMAGES):
        d = root / f"class_{i % 4}"
        d.mkdir(exist_ok=True)
        h, w = SIZES[i % len(SIZES)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            d / f"im{i:02d}.jpg", quality=90)
    prefix = str(root / "train")
    jax_im2rec.pack(str(root), prefix, jax_im2rec.build_list(str(root)),
                    num_shards=2)
    _append_corrupt(prefix + "_000.rec", prefix + "_000.idx", N_IMAGES)
    return str(root)


def _cfgs(data_dir, **data):
    out = []
    for cfg in (JaxConfig(), Config()):
        d = cfg.data
        d.data_dir, d.train_rec, d.val_rec = data_dir, "train", "train"
        d.image_shape, d.preprocess_threads = (32, 32, 3), 3
        for k, v in data.items():
            setattr(d, k, v)
        cfg.train.batch_size, cfg.train.seed = BATCH, 5
        out.append(cfg)
    return out


def _assert_streams_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x) == set(y), i
        for k in x:
            assert x[k].dtype == y[k].dtype, (i, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


def test_native_loader_is_built_and_chosen(pack):
    assert ensure_built().exists()
    _, cfg = _cfgs(pack)
    assert isinstance(RecordIter(cfg, train=True).loader, NativeRecordLoader)


def test_record_train_and_val_epochs_are_byte_equal(pack):
    jcfg, cfg = _cfgs(pack)
    assert resolve_shards(pack, "train") == [
        os.path.join(pack, "train_000.rec"), os.path.join(pack, "train_001.rec")]
    jit, it = JaxRecordIter(jcfg, train=True), RecordIter(cfg, train=True)
    assert it.steps_per_epoch == jit.steps_per_epoch == (N_IMAGES + 1) // BATCH
    for epoch in (0, 1):
        batches = list(it.epoch_iter(epoch))
        _assert_streams_equal(batches, jit.epoch_iter(epoch))
        assert all("dims" in b and b["image"].shape == (BATCH, 32, 32, 3)
                   for b in batches)
        assert len({tuple(d) for b in batches for d in b["dims"]}) > 3
    assert it.state_dict() == jit.state_dict()
    jval, val = JaxRecordIter(jcfg, train=False), RecordIter(cfg, train=False)
    batches = list(val.epoch_iter(0))
    _assert_streams_equal(batches, jval.epoch_iter(0))
    # 48 good records of 49: four full batches and a padded one of 8
    assert [int(b["mask"].sum()) for b in batches] == [10, 10, 10, 10, 8]


def test_mid_epoch_cursor_replays_the_same_stream(pack):
    jcfg, cfg = _cfgs(pack)
    streams = []
    for make in (lambda: JaxRecordIter(jcfg, train=True),
                 lambda: RecordIter(cfg, train=True)):
        full = list(make().epoch_iter(1))
        it = make()
        gen = it.epoch_iter(1)
        head = [next(gen) for _ in range(2)]
        cursor = it.cursor_state(2)
        gen.close()
        resumed = make()
        resumed.load_state_dict(cursor)
        tail = list(resumed.epoch_iter(1))
        _assert_streams_equal(head + tail, full)
        streams.append((cursor, head + tail))
    assert streams[0][0] == streams[1][0]
    _assert_streams_equal(streams[0][1], streams[1][1])


def test_python_loader_matches_jax_python_loader(pack):
    from resnet_tpu.data.native import PythonRecordLoader as JaxPython
    recs = resolve_shards(pack, "train")
    idxs = [r[:-4] + ".idx" for r in recs]
    for letterbox in (True, False):
        a = PythonRecordLoader(recs, idxs, (32, 32), letterbox=letterbox)
        b = JaxPython(recs, idxs, (32, 32), letterbox=letterbox)
        for lo in (a, b):
            lo.begin_epoch(0, True, 5)
        for _ in range(3):
            for x, y in zip(a.next_batch(17), b.next_batch(17)):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)


def test_recordio_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    # payloads that embed the magic word force the split-record framing
    payloads = [rng.bytes(n) for n in (0, 3, 17, 64)]
    payloads.append(b"ab" + recordio._MAGIC_BYTES + b"cdefgh"
                    + recordio._MAGIC_BYTES)
    for writer_mod, reader_mod in ((recordio, jax_recordio),
                                   (jax_recordio, recordio)):
        rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
        with writer_mod.RecordIOWriter(rec, idx) as w:
            for p in payloads:
                w.write(p)
        r = reader_mod.RecordIOReader(rec, idx)
        assert list(r) == payloads
        assert [r.read_at(o) for o in r.offsets] == payloads
        r.close()
    packed = recordio.pack_image_record(b"jpeg", 3.0, rec_id=7,
                                        extra_labels=(1.0, 2.0))
    assert packed == jax_recordio.pack_image_record(
        b"jpeg", 3.0, rec_id=7, extra_labels=(1.0, 2.0))
    assert vars(recordio.unpack_image_record(packed)) == \
        vars(jax_recordio.unpack_image_record(packed))


def test_memory_and_synthetic_iterators_match_jax():
    images, labels = synthetic_cifar(45, 10, (8, 8, 3), seed=2)
    jimages, jlabels = jax_synthetic_cifar(45, 10, (8, 8, 3), seed=2)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)
    for kw in (dict(shuffle=True), dict(shuffle=False, drop_last=False,
                                        pad_last=True)):
        a = MemoryIter(images, labels, 8, seed=4, **kw)
        b = JaxMemoryIter(images, labels, 8, seed=4, **kw)
        for epoch in (0, 1):
            _assert_streams_equal(a.epoch_iter(epoch), b.epoch_iter(epoch))
        a.load_state_dict({"epoch": 1, "batch": 2})
        b.load_state_dict({"epoch": 1, "batch": 2})
        _assert_streams_equal(a.epoch_iter(1), b.epoch_iter(1))
    _assert_streams_equal(
        SyntheticIter(4, (8, 8, 3), 10, steps_per_epoch=3, seed=1)
        .epoch_iter(0),
        JaxSyntheticIter(4, (8, 8, 3), 10, steps_per_epoch=3, seed=1)
        .epoch_iter(0))


def test_pipeline_selectors_match_jax(pack):
    for pipeline in ("memory", "synthetic", "record"):
        jcfg, cfg = _cfgs(pack, pipeline=pipeline, num_examples=45)
        _assert_streams_equal(make_train_iter(cfg).epoch_iter(0),
                              jax_make_train_iter(jcfg).epoch_iter(0))
        jval, val = jax_make_val_iter(jcfg), make_val_iter(cfg)
        assert (val is None) == (jval is None)
        if val is not None:
            _assert_streams_equal(val.epoch_iter(0), jval.epoch_iter(0))


@pytest.mark.parametrize("n_batches,k", [(7, 3), (6, 3), (2, 4)])
def test_prefetch_grouped_order_stacking_and_tail(n_batches, k):
    rng = np.random.default_rng(n_batches)
    host = [{"image": rng.integers(0, 256, (2, 4, 4, 3), np.uint8),
             "label": rng.integers(0, 9, (2,)).astype(np.int32)}
            for _ in range(n_batches)]
    got = list(prefetch_grouped(iter(host), k, size=2, device="cpu"))
    want = list(jax_prefetch_grouped(iter(host), k, size=2))
    assert [n for _, n in got] == [n for _, n in want] == \
        [k] * (n_batches // k) + [1] * (n_batches % k)
    for (gb, _), (wb, _) in zip(got, want):
        for name in wb:
            assert isinstance(gb[name], torch.Tensor)
            assert gb[name].device.type == "cpu"
            np.testing.assert_array_equal(gb[name].numpy(),
                                          np.asarray(jax.device_get(wb[name])))
