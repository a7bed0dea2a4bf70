"""MXNet ``.params`` files between the port and the JAX package.

A file the port writes (``save_mxnet_style``) is read by the JAX
package's reader with equal arrays, and the other way round; a ResNet
checkpoint the JAX package writes, loaded by the port's
``load_mxnet_checkpoint``, gives the JAX model's eval logits at rtol/atol
1e-4, the model tolerance of tests/test_torch_port_model.py (the two
frameworks sum convolutions in different orders). The arrays themselves
cross exactly."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.models.registry import get_model as jax_get_model
from resnet_tpu.utils import mxnet_params as jax_mxnet_params
from resnet_tpu.utils.export import save_mxnet_style as jax_save_mxnet
from resnet_tpu_torch.config import Config
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.utils import mxnet_params
from resnet_tpu_torch.utils.export import (export_mxnet_params,
                                           load_mxnet_checkpoint,
                                           save_mxnet_style)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    args = {"conv0_weight": rng.normal(0, 1, (4, 3, 7, 7)).astype(np.float32),
            "fc1_bias": rng.normal(0, 1, (10,)).astype(np.float32),
            "bn0_gamma": np.ones(4, np.float32)}
    auxs = {"bn0_moving_var": rng.random(4).astype(np.float32) + 0.5,
            "bn0_moving_mean": np.zeros(4, np.float32)}
    return args, auxs


def _assert_tables_equal(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_params_files_cross_both_ways(tmp_path):
    args, auxs = _tables()
    mxnet_params.save_params(str(tmp_path / "port.params"), args, auxs)
    _assert_tables_equal(
        jax_mxnet_params.load_params(str(tmp_path / "port.params")),
        (args, auxs))
    jax_mxnet_params.save_params(str(tmp_path / "jax.params"), args, auxs)
    _assert_tables_equal(
        mxnet_params.load_params(str(tmp_path / "jax.params")), (args, auxs))
    assert (tmp_path / "port.params").read_bytes() == \
        (tmp_path / "jax.params").read_bytes()


def _cfg(cls):
    cfg = cls()
    cfg.model.depth = 18
    cfg.data.num_classes, cfg.data.image_shape = 10, (32, 32, 3)
    return cfg


def test_port_checkpoint_read_by_jax(tmp_path):
    state = create_train_state(_cfg(Config), device="cpu")
    prefix = str(tmp_path / "r18")
    assert save_mxnet_style(prefix, 3, state, fmt="params") == \
        f"{prefix}-0003.params"
    _assert_tables_equal(jax_mxnet_params.load_params(f"{prefix}-0003.params"),
                         export_mxnet_params(state))
    npz = np.load(save_mxnet_style(prefix, 3, state, fmt="npz"))
    args, auxs = export_mxnet_params(state)
    assert sorted(npz.files) == sorted(
        [f"arg:{k}" for k in args] + [f"aux:{k}" for k in auxs])


def test_jax_checkpoint_gives_jax_eval_logits(tmp_path):
    jcfg = _cfg(JaxConfig)
    model = jax_get_model(jcfg)
    x = np.random.default_rng(1).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    # random values of the init's shapes (no init compile); non-trivial
    # running statistics, so a mean/var mix-up would show
    shapes = jax.eval_shape(partial(model.init, train=False),
                            jax.random.key(3), jnp.asarray(x))
    rng = np.random.default_rng(2)

    def rand(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(0, 0.5, leaf.shape)
        if name == "kernel":     # the MSRA scale, HWIO fan-in
            a = a * np.sqrt(4.0 / np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a, leaf.dtype)
    variables = jax.tree_util.tree_map_with_path(rand, shapes)
    stats = variables["batch_stats"]
    prefix = str(tmp_path / "jax")
    jax_save_mxnet(prefix, 2, variables["params"], stats, fmt="params")
    want = jax.jit(model.apply, static_argnames="train")(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), train=False)

    state = create_train_state(_cfg(Config), device="cpu")
    load_mxnet_checkpoint(prefix, 2, state)
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
