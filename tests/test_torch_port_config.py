"""The port's configuration and command line against the JAX package's:
every field both configs have must be equal after parsing the same argv,
and every preset must equal the JAX preset. The switches of ROADMAP items
11, 14, 15 and 17 (the model family, remat, the pool backward, the warps,
the split augmenter, data parallelism, ``--xla-opts``) are ported: they
parse as the JAX package parses them, more than one device inside the
launcher's environment only. ``--xla-opts`` carries the port's backend
options, so a key only XLA knows raises ``ValueError`` in the entry point
before any step."""

import dataclasses

import pytest

from resnet_tpu import config as jax_config
from resnet_tpu_torch import config

ARGVS = [
    [],
    ["--preset", "imagenet_resnet50"],
    ["--preset", "imagenet_resnet50", "--lr-steps", "30,60,80",
     "--lr-factor", "0.2", "--num-epochs", "90", "--warmup",
     "--warmup-epochs", "3"],
    ["--preset", "imagenet_resnet50", "--bn-ema-warmup", "12",
     "--frequent", "6", "--checkpoint-frequent", "50"],
    ["--preset", "imagenet_resnet50", "--no-bn-ema", "--unit-chain",
     "pallas"],
    ["--preset", "imagenet_resnet50", "--no-bn-ema", "--fused-convbn",
     "--bn-subsample", "8", "--bn-grouped"],
    ["--pipeline", "record", "--data-dir", "/data/imagenet", "--train-rec",
     "train_*.rec", "--val-rec", "val", "--preprocess-threads", "12",
     "--canvas-size", "288", "--image-shape", "192,192,3"],
    ["--preset", "imagenet_resnet50", "--auto-resume", "--model-prefix",
     "ck/r50", "--load-epoch", "3", "--seed", "7", "--check-numerics"],
    ["--preset", "imagenet_resnet101_bf16", "--dtype", "float32",
     "--optimizer", "nag", "--label-smooth", "0.1", "--augment-impl", "xla",
     "--no-random-resized-crop", "--max-random-contrast", "0.3",
     "--min-aspect-ratio", "0.5", "--no-stem-s2d", "--no-aug-s2d",
     "--steps-per-dispatch", "4", "--no-spd-unroll"],
    ["--depth", "34", "--batch-size", "64", "--lr", "0.025", "--mom", "0.8",
     "--wd", "5e-5", "--bn-stat-stride", "2", "--bn-ema", "--bn-ema-clamp",
     "1.5", "--no-bn-ema-project", "--num-devices", "1", "--random-h", "0",
     "--max-random-illumination", "20", "--pipeline", "synthetic"],
]


def _fields(cfg):
    return {f"{sec}.{f.name}": getattr(getattr(cfg, sec), f.name)
            for sec in ("data", "model", "train")
            for f in dataclasses.fields(getattr(cfg, sec))}


def _assert_same(port_cfg, jax_cfg):
    mine, theirs = _fields(port_cfg), _fields(jax_cfg)
    # the port keeps every field of the JAX config
    assert set(mine) == set(theirs)
    diff = {k: (mine[k], theirs[k]) for k in mine if mine[k] != theirs[k]}
    assert diff == {}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_parse_config_agrees_with_jax(argv):
    _assert_same(config.parse_config(argv), jax_config.parse_config(argv))


def test_presets_and_defaults_agree_with_jax():
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    for name in config.PRESETS:
        _assert_same(config.PRESETS[name](), jax_config.PRESETS[name]())
    _assert_same(config.Config(), jax_config.Config())
    assert config.TrainConfig().bn_ema_warmup == -2


def test_every_jax_flag_is_accepted():
    ours = {a.dest for a in config.build_parser()._actions}
    theirs = {a.dest for a in jax_config.build_parser()._actions}
    assert theirs <= ours and ours - theirs == {"device"}


# the ROADMAP items whose switches the port has: all of them
PORTED_ITEMS = (11, 14, 15, 17)


@pytest.mark.parametrize("argv,item", [
    (["--version", "2"], 14),
    (["--dataset", "cifar10"], 14),
    (["--preset", "cifar10_resnet18"], 14),
    (["--preset", "imagenet_resnext50"], 14),
    (["--preset", "imagenet_resnet152_dp"], 15),
    (["--remat"], 14),
    (["--remat-policy", "conv"], 14),
    (["--pool-grad", "mask"], 14),
    (["--num-devices", "2", "--dp-mode", "shard_map"], 15),
    (["--max-rotate-angle", "10"], 11),
    (["--max-shear-ratio", "0.1", "--rotate-backend", "device"], 14),
    (["--augment-impl", "pallas-split"], 14),
    (["--xla-opts", "xla_cpu_enable_fast_math=true"], 17),
], ids=lambda v: " ".join(v) if isinstance(v, list) else str(v))
def test_unported_switch_raises(argv, item, monkeypatch):
    """Every switch of the items that were once refused (11, 14, 15, 17)
    parses to the JAX package's config; item 15's more than one device
    only with the launcher's rendezvous set."""
    assert item in PORTED_ITEMS
    want = jax_config.parse_config(argv)   # the JAX package accepts it
    if item == 15:
        monkeypatch.delenv(config.ENV_COORD, raising=False)
        with pytest.raises(ValueError, match="tools.launch"):
            config.parse_config(argv)
        monkeypatch.setenv(config.ENV_COORD, "127.0.0.1:1")
    _assert_same(config.parse_config(argv), want)


def test_xla_only_key_raises_in_the_entry_point_before_any_step(
        monkeypatch, tmp_path):
    """The JAX test's XLA flag parses, and the entry point refuses it as a
    backend option, naming the known keys, before the fit starts."""
    from resnet_tpu_torch import train_resnet

    def no_fit(*a, **k):
        raise AssertionError("the fit started")

    monkeypatch.setattr(train_resnet.Solver, "fit", no_fit)
    with pytest.raises(ValueError, match="cudnn_benchmark, "
                       "cudnn_deterministic, tf32"):
        train_resnet.main([
            "--device", "cpu", "--preset", "cifar10_resnet18", "--depth",
            "8", "--pipeline", "synthetic", "--num-examples", "32",
            "--batch-size", "16", "--model-prefix", str(tmp_path / "ck"),
            "--xla-opts", "xla_cpu_enable_fast_math=true"])


def test_solver_refuses_unported_presets(monkeypatch):
    """Every preset is ported; imagenet_resnet152_dp's 16 devices need 16
    processes, which only the launcher starts."""
    from resnet_tpu_torch.train.solver import Solver
    monkeypatch.delenv(config.ENV_COORD, raising=False)
    with pytest.raises(ValueError, match="tools.launch -n 16"):
        Solver(config.PRESETS["imagenet_resnet152_dp"](), device="cpu")
    for name in ("imagenet_resnet50", "imagenet_resnet101_bf16",
                 "cifar10_resnet18", "imagenet_resnext50"):
        config.require_ported(config.PRESETS[name]())
