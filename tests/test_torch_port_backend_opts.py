"""``--xla-opts`` as the port's backend options (``utils/xla_opts.py``)
against the JAX package's ``utils/xla_opts.py``, and where the port keeps
its built libraries (``utils/cache.py``).

``parse_opts`` equals the JAX function on the strings of
``tests/test_xla_opts.py`` and a few more; ``compiler_options`` keeps the
JAX semantics (``"off"``, explicit options only off the accelerator, the
accelerator's defaults plus the explicit ones); ``apply_backend_options``
sets each of its three switches and puts them back, and raises on any
other key before it sets anything; the entry point trains under
``--xla-opts``."""

import pytest
import torch

from resnet_tpu.utils import xla_opts as jax_xla_opts
from resnet_tpu_torch import _build
from resnet_tpu_torch.data import native
from resnet_tpu_torch.utils import cache, xla_opts


@pytest.mark.parametrize("spec", [
    "", None, "a=1", "a=1, b = x ", "k=v", "off", "a", "a=", "=v",
    "a=1,,b=2,", " a = 1 , a = 2 ", "x=y=z",
    "xla_cpu_enable_fast_math=true", "cudnn_benchmark=0,tf32=1"])
def test_parse_opts_equals_jax(spec):
    assert xla_opts.parse_opts(spec) == jax_xla_opts.parse_opts(spec)


def test_off_disables_everything():
    for backend in ("cuda", "cpu"):
        assert xla_opts.compiler_options("off", backend=backend) is None
    assert jax_xla_opts.compiler_options("off", backend="tpu") is None


def test_cpu_gets_no_cuda_defaults():
    assert xla_opts.compiler_options(None, backend="cpu") is None
    assert xla_opts.compiler_options("a=1", backend="cpu") == {"a": "1"}
    assert xla_opts.compiler_options("a=1", backend="cpu") == \
        jax_xla_opts.compiler_options("a=1", backend="cpu")


def test_cuda_defaults_plus_explicit():
    assert xla_opts.CUDA_DEFAULTS == {"cudnn_benchmark": "1"}
    assert xla_opts.compiler_options(None, backend="cuda") == \
        xla_opts.CUDA_DEFAULTS
    got = xla_opts.compiler_options("k=v", backend="cuda")
    assert got == dict(xla_opts.CUDA_DEFAULTS, k="v")
    assert xla_opts.compiler_options("cudnn_benchmark=0", backend="cuda") \
        == {"cudnn_benchmark": "0"}


def test_deterministic_algorithms_keep_the_autotuner_off():
    """``fit_resume`` holds two runs bit for bit on deterministic
    algorithms: the default must not turn the autotuner on there."""
    assert not torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert xla_opts.compiler_options(None, backend="cuda") is None
        assert xla_opts.compiler_options("tf32=0", backend="cuda") == \
            {"tf32": "0"}
    finally:
        torch.use_deterministic_algorithms(False)


SWITCHES = {
    "cudnn_benchmark": lambda: torch.backends.cudnn.benchmark,
    "cudnn_deterministic": lambda: torch.backends.cudnn.deterministic,
    "tf32": lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32),
}


def _all_switches():
    return (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("key", sorted(SWITCHES))
def test_apply_sets_and_restores_the_switch(key, value):
    before = _all_switches()
    restore = xla_opts.apply_backend_options({key: value})
    try:
        want = value == "1"
        got = SWITCHES[key]()
        assert got == ((want, want) if key == "tf32" else want)
    finally:
        restore()
    assert _all_switches() == before


@pytest.mark.parametrize("opts", [
    {"xla_cpu_enable_fast_math": "true"},
    {"cudnn_benchmark": "1", "xla_tpu_scoped_vmem_limit_kib": "65536"}])
def test_an_unknown_key_raises_naming_the_known_ones(opts):
    before = _all_switches()
    with pytest.raises(ValueError, match="cudnn_benchmark, "
                       "cudnn_deterministic, tf32"):
        xla_opts.apply_backend_options(opts)
    assert _all_switches() == before   # nothing was set


def test_a_value_other_than_0_or_1_raises():
    with pytest.raises(ValueError, match="0 or 1"):
        xla_opts.apply_backend_options({"tf32": "true"})
    assert xla_opts.apply_backend_options(None)() is None


def test_entry_point_trains_under_backend_options(tmp_path):
    from resnet_tpu_torch.train_resnet import main
    before = _all_switches()
    try:
        state = main(["--device", "cpu", "--preset", "cifar10_resnet18",
                      "--depth", "8", "--image-shape", "16,16,3",
                      "--num-examples", "32", "--batch-size", "16",
                      "--num-epochs", "1", "--pipeline", "synthetic",
                      "--xla-opts", "cudnn_benchmark=0,tf32=0",
                      "--model-prefix", str(tmp_path / "ck")])
        assert state.step == 2
        assert torch.backends.cudnn.benchmark is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        xla_opts._restore(before)


def test_compile_cache_moves_both_libraries_and_back(tmp_path, monkeypatch):
    default = _build.DEFAULT_BUILD_DIR
    assert _build.BUILD_DIR == native.BUILD_DIR == default
    monkeypatch.delenv(cache.ENV_CACHE, raising=False)
    try:
        got = cache.enable_compile_cache(str(tmp_path / "c"))
        assert got == str(tmp_path / "c") and (tmp_path / "c").is_dir()
        assert cache.enable_compile_cache(got) == got   # idempotent
        assert _build._library_path("augment").parent == tmp_path / "c"
        assert native.library_path().parent == tmp_path / "c"
        monkeypatch.setenv(cache.ENV_CACHE, str(tmp_path / "env"))
        assert cache.enable_compile_cache() == str(tmp_path / "env")
        assert _build._library_path("bn_sums").parent == tmp_path / "env"
        monkeypatch.delenv(cache.ENV_CACHE)
        assert cache.enable_compile_cache() == str(default)
        assert _build._library_path("augment").parent == default
        assert native.library_path().parent == default
    finally:
        _build.BUILD_DIR = native.BUILD_DIR = default
