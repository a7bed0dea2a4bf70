"""The port's ``-symbol.json`` (``resnet_tpu_torch/utils/symbol_export.py``)
against the JAX package's: the same graph JSON byte for byte over the
families, the same parse of every attr vintage, a variable set that is the
port's ``.params`` names, and the same errors. Pure Python: models are
built for their parameter names, never run."""

import json

import pytest

from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.utils import symbol_export as jax_sym
from resnet_tpu_torch.config import Config
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.utils import symbol_export as sym
from resnet_tpu_torch.utils.export import export_mxnet_params

# (network, depth, version, dataset, classes)
CASES = {
    "r50v1": ("resnet", 50, 1, "imagenet", 1000),
    "x50_32x4d": ("resnext", 50, 1, "imagenet", 1000),
    "r50v2": ("resnet", 50, 2, "imagenet", 10),
    "cifar20": ("resnet", 20, 1, "cifar10", 10),
    "cifar164_bottleneck": ("resnet", 164, 1, "cifar10", 10),
}


def _cfgs(case):
    network, depth, version, dataset, classes = CASES[case]
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.model.network, cfg.model.depth = network, depth
        cfg.model.version, cfg.model.dataset = version, dataset
        cfg.data.num_classes = classes
        out.append(cfg)
    return out


def _revintage(txt, key):
    """The graph with every node's ``attrs`` renamed to ``key`` (MXNet's
    older json vintages: ``attr``, ``param``)."""
    g = json.loads(txt)
    for n in g["nodes"]:
        if "attrs" in n:
            n[key] = n.pop("attrs")
    return json.dumps(g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_symbol_json_is_the_jax_packages_byte_for_byte(case, tmp_path):
    jcfg, cfg = _cfgs(case)
    txt = sym.symbol_json(cfg)
    assert txt == jax_sym.symbol_json(jcfg)
    path = sym.save_symbol(str(tmp_path / "m"), cfg)
    assert path == str(tmp_path / "m-symbol.json")
    with open(path) as f:
        assert f.read() == txt


@pytest.mark.parametrize("vintage", ["attrs", "attr", "param"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_equals_the_jax_parse_in_every_vintage(case, vintage):
    jcfg, cfg = _cfgs(case)
    txt = sym.symbol_json(cfg)
    if vintage != "attrs":
        txt = _revintage(txt, vintage)
    got = sym.parse_symbol_json(txt)
    assert got == jax_sym.parse_symbol_json(txt)
    network, depth, version, dataset, classes = CASES[case]
    assert (got["model"]["network"], got["model"]["depth"],
            got["model"]["version"], got["model"]["dataset"],
            got["num_classes"]) == (network, depth, version, dataset, classes)


@pytest.mark.parametrize("case", ["r50v1", "x50_32x4d", "r50v2", "cifar20"])
def test_config_from_symbol_restores_the_network(case, tmp_path):
    jcfg, cfg = _cfgs(case)
    path = sym.save_symbol(str(tmp_path / "m"), cfg)
    # a config that names another network entirely
    wrong = Config()
    wrong.model.depth, wrong.data.num_classes = 18, 3
    wrong.train.dtype = "bfloat16"
    got = sym.config_from_symbol(wrong, path)
    jwrong = JaxConfig()
    jwrong.model.depth, jwrong.data.num_classes = 18, 3
    want = jax_sym.config_from_symbol(jwrong, path)
    for field in ("network", "depth", "version", "dataset", "bn_mom",
                  "bn_eps", "group_width"):
        assert getattr(got.model, field) == getattr(want.model, field) == \
            getattr(cfg.model, field), field
    if cfg.model.network == "resnext":
        assert got.model.cardinality == cfg.model.cardinality
    assert got.data.num_classes == cfg.data.num_classes
    assert got.train.dtype == "bfloat16"      # not the symbol's to say


@pytest.mark.parametrize("case", sorted(CASES))
def test_variable_set_is_the_ports_params_names(case):
    _, cfg = _cfgs(case)
    graph = json.loads(sym.symbol_json(cfg))
    variables = {graph["nodes"][i]["name"] for i in graph["arg_nodes"]}
    args, auxs = export_mxnet_params(get_model(cfg))
    extra = {"data", "softmax_label"}
    if cfg.model.version == 2:
        extra.add("bn_data_gamma")     # fix_gamma: MXNet holds it fixed
    assert variables == set(args) | set(auxs) | extra


def _graph_with_units(units):
    """A v1 basic-block graph whose stages hold ``units`` residual adds."""
    g = sym._Graph()
    x = g.var("data")
    x = sym._conv(g, x, "conv0", 64, "(7, 7)", "(2, 2)", "(3, 3)")
    for s, n in enumerate(units):
        for u in range(n):
            x = sym._residual_unit(g, x, f"stage{s + 1}_unit{u + 1}", 64, 64,
                                   "(1, 1)", True, False, 1, 1, 0.9, 2e-5)
    x = g.op("FullyConnected", "fc1", [x], {"num_hidden": "10"})
    return g.json(x)


def _errors(txt):
    out = []
    for parse in (sym.parse_symbol_json, jax_sym.parse_symbol_json):
        with pytest.raises(ValueError) as e:
            parse(txt)
        out.append(str(e.value))
    return out


def test_unknown_depth_raises_as_the_jax_package_does():
    port, jax_msg = _errors(_graph_with_units((5, 5, 5, 5)))
    assert port == jax_msg
    assert "match no known depth table" in port


def test_foreign_naming_raises_as_the_jax_package_does():
    _, cfg = _cfgs("cifar20")
    txt = sym.symbol_json(cfg).replace('"stage1_unit1_plus"',
                                       '"block_a_add"')
    port, jax_msg = _errors(txt)
    assert port == jax_msg
    assert "'block_a_add' is not stageN_unitM" in port
    g = json.loads(txt)
    g["nodes"] = [n for n in g["nodes"] if n["op"] != "FullyConnected"]
    assert _errors(json.dumps(g))[0] == "symbol has no FullyConnected head"
