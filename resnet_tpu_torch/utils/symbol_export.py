"""MXNet ``-symbol.json``: the graph half of the checkpoint pair. Port of
``resnet_tpu/utils/symbol_export.py``.

``mx.model.save_checkpoint`` writes ``{prefix}-symbol.json`` (the NNVM
graph, ``sym.tojson()``) next to the ``.params`` blob. ``utils/export.py``
writes the params half; this module writes the graph half, so that the
exported pair is whole: an MXNet user can ``mx.model.load_checkpoint(prefix,
epoch)`` and bind the result. It also reads such a graph back into a model
configuration (:func:`config_from_symbol`), which is how ``predict`` and
``serve_export`` take the network from a foreign checkpoint pair.

``symbol_json`` walks the port's depth tables and ``models/registry.py::
model_spec`` (the same stems, stage/unit loop, v1/v2 orderings and ResNeXt
``num_group`` as ``models/resnet.py``) under the reference's node names
(``stageN_unitM_conv1``, ``bn0``, ``fc1``, ``softmax``), so the symbol's
variable set is ``utils/export.py``'s parameter names. The JSON is the JAX
package's byte for byte for every configuration: both describe one MXNet
graph.

JSON layout (NNVM graph, as ``nnvm::pass::SaveJSON`` emits it):
  nodes:        [{op, name, attrs?, inputs: [[node, out_idx, version]]}]
  arg_nodes:    indices of every ``op == "null"`` node (data, weights, BN
                stats, label)
  node_row_ptr: cumulative output counts (BatchNorm contributes 3 -
                out/mean/var; everything else 1)
  heads:        [[last_node, 0, 0]]
  attrs:        {"mxnet_version": ["int", 10600]}

Numeric attrs are written in MXNet's tuple/str conventions. v2 graphs
carry the reference's leading ``bn_data`` with ``fix_gamma=True``: MXNet
holds a (fixed) gamma argument the port's model does not have; bind with
``allow_missing=True`` or give ``bn_data_gamma`` a ones vector.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional

from resnet_tpu_torch.config import Config
from resnet_tpu_torch.models.registry import model_spec
from resnet_tpu_torch.models.resnet import BOTTLENECK_MIN_DEPTH, IMAGENET_UNITS


class _Graph:
    def __init__(self):
        self.nodes: List[dict] = []
        self.arg_nodes: List[int] = []
        self.row_ptr: List[int] = [0]

    def var(self, name: str) -> int:
        return self._add({"op": "null", "name": name, "inputs": []}, 1)

    def op(self, op: str, name: str, inputs: List[int],
           attrs: Optional[Dict[str, str]] = None, n_out: int = 1) -> int:
        node = {"op": op, "name": name,
                "inputs": [[i, 0, 0] for i in inputs]}
        if attrs:
            node["attrs"] = attrs
        return self._add(node, n_out)

    def _add(self, node: dict, n_out: int) -> int:
        idx = len(self.nodes)
        self.nodes.append(node)
        if node["op"] == "null":
            self.arg_nodes.append(idx)
        self.row_ptr.append(self.row_ptr[-1] + n_out)
        return idx

    def json(self, head: int) -> str:
        return json.dumps({
            "nodes": self.nodes,
            "arg_nodes": self.arg_nodes,
            "node_row_ptr": self.row_ptr,
            "heads": [[head, 0, 0]],
            "attrs": {"mxnet_version": ["int", 10600]},
        }, indent=2)


def _conv(g: _Graph, x: int, name: str, num_filter: int, kernel, stride,
          pad, num_group: int = 1) -> int:
    attrs = {"kernel": str(kernel), "stride": str(stride),
             "pad": str(pad), "num_filter": str(num_filter),
             "no_bias": "True", "workspace": "512"}
    if num_group > 1:
        attrs["num_group"] = str(num_group)
    w = g.var(f"{name}_weight")
    return g.op("Convolution", name, [x, w], attrs)


def _bn(g: _Graph, x: int, name: str, mom: float, eps: float,
        fix_gamma: bool = False) -> int:
    gamma = g.var(f"{name}_gamma")
    beta = g.var(f"{name}_beta")
    mean = g.var(f"{name}_moving_mean")
    var = g.var(f"{name}_moving_var")
    return g.op("BatchNorm", name, [x, gamma, beta, mean, var],
                {"momentum": str(mom), "eps": str(eps),
                 "fix_gamma": str(fix_gamma), "use_global_stats": "False"},
                n_out=3)


def _relu(g: _Graph, x: int, name: str) -> int:
    return g.op("Activation", name, [x], {"act_type": "relu"})


def _residual_unit(g: _Graph, x: int, name: str, filters: int, mid: int,
                   stride, dim_match: bool, bottleneck: bool, version: int,
                   num_group: int, mom: float, eps: float) -> int:
    s, p1 = str(stride), "(1, 1)"
    if version == 2:
        bn1 = _bn(g, x, f"{name}_bn1", mom, eps)
        act1 = _relu(g, bn1, f"{name}_relu1")
        sc = x if dim_match else _conv(
            g, act1, f"{name}_sc", filters, "(1, 1)", s, "(0, 0)")
        if bottleneck:
            y = _conv(g, act1, f"{name}_conv1", mid, "(1, 1)", "(1, 1)",
                      "(0, 0)")
            y = _relu(g, _bn(g, y, f"{name}_bn2", mom, eps),
                      f"{name}_relu2")
            y = _conv(g, y, f"{name}_conv2", mid, "(3, 3)", s, p1,
                      num_group)
            y = _relu(g, _bn(g, y, f"{name}_bn3", mom, eps),
                      f"{name}_relu3")
            y = _conv(g, y, f"{name}_conv3", filters, "(1, 1)", "(1, 1)",
                      "(0, 0)")
        else:
            y = _conv(g, act1, f"{name}_conv1", mid, "(3, 3)", s, p1)
            y = _relu(g, _bn(g, y, f"{name}_bn2", mom, eps),
                      f"{name}_relu2")
            y = _conv(g, y, f"{name}_conv2", filters, "(3, 3)", "(1, 1)",
                      p1)
        return g.op("elemwise_add", f"{name}_plus", [y, sc])

    # v1 post-activation
    if dim_match:
        sc = x
    else:
        sc = _conv(g, x, f"{name}_sc", filters, "(1, 1)", s, "(0, 0)")
        sc = _bn(g, sc, f"{name}_sc_bn", mom, eps)
    if bottleneck:
        y = _conv(g, x, f"{name}_conv1", mid, "(1, 1)", "(1, 1)", "(0, 0)")
        y = _relu(g, _bn(g, y, f"{name}_bn1", mom, eps), f"{name}_relu1")
        y = _conv(g, y, f"{name}_conv2", mid, "(3, 3)", s, p1, num_group)
        y = _relu(g, _bn(g, y, f"{name}_bn2", mom, eps), f"{name}_relu2")
        y = _conv(g, y, f"{name}_conv3", filters, "(1, 1)", "(1, 1)",
                  "(0, 0)")
        y = _bn(g, y, f"{name}_bn3", mom, eps)
    else:
        y = _conv(g, x, f"{name}_conv1", mid, "(3, 3)", s, p1)
        y = _relu(g, _bn(g, y, f"{name}_bn1", mom, eps), f"{name}_relu1")
        y = _conv(g, y, f"{name}_conv2", filters, "(3, 3)", "(1, 1)", p1)
        y = _bn(g, y, f"{name}_bn2", mom, eps)
    add = g.op("elemwise_add", f"{name}_plus", [y, sc])
    return _relu(g, add, f"{name}_relu")


def symbol_json(cfg: Config) -> str:
    """Build the NNVM symbol JSON for ``cfg``'s model (mirrors
    ``models/resnet.py`` — same depth tables, stems, width rules)."""
    m = cfg.model
    units, filters, bottleneck, cifar = model_spec(m, cfg.data.num_classes)
    mom, eps = m.bn_mom, m.bn_eps
    cardinality = m.cardinality if m.network == "resnext" else 1

    g = _Graph()
    x = g.var("data")
    if m.version == 2:
        x = _bn(g, x, "bn_data", mom, eps, fix_gamma=True)
    if cifar:
        x = _conv(g, x, "conv0", filters[0], "(3, 3)", "(1, 1)", "(1, 1)")
        if m.version == 1:
            x = _relu(g, _bn(g, x, "bn0", mom, eps), "relu0")
    else:
        x = _conv(g, x, "conv0", filters[0], "(7, 7)", "(2, 2)", "(3, 3)")
        x = _relu(g, _bn(g, x, "bn0", mom, eps), "relu0")
        x = g.op("Pooling", "pool0", [x],
                 {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
                  "pool_type": "max"})

    for stage, (n_units, n_filter) in enumerate(zip(units, filters[1:])):
        for unit in range(n_units):
            first = unit == 0
            stride = "(2, 2)" if (first and stage > 0) else "(1, 1)"
            if cardinality > 1 and bottleneck:
                mid = max(n_filter * cardinality * m.group_width // 256,
                          cardinality)
            elif bottleneck:
                mid = n_filter // 4
            else:
                mid = n_filter
            x = _residual_unit(
                g, x, f"stage{stage + 1}_unit{unit + 1}", n_filter, mid,
                stride, dim_match=not first, bottleneck=bottleneck,
                version=m.version,
                num_group=cardinality if bottleneck else 1,
                mom=mom, eps=eps)

    if m.version == 2:
        x = _relu(g, _bn(g, x, "bn_final", mom, eps), "relu_final")
    x = g.op("Pooling", "pool1", [x],
             {"global_pool": "True", "kernel": "(7, 7)",
              "pool_type": "avg"})
    x = g.op("Flatten", "flatten0", [x])
    w = g.var("fc1_weight")
    b = g.var("fc1_bias")
    x = g.op("FullyConnected", "fc1", [x, w, b],
             {"num_hidden": str(cfg.data.num_classes)})
    label = g.var("softmax_label")
    head = g.op("SoftmaxOutput", "softmax", [x, label])
    return g.json(head)


def save_symbol(path_prefix: str, cfg: Config) -> str:
    """Write ``{prefix}-symbol.json`` (the reference checkpoint pair's
    graph half; pair with ``save_mxnet_style(..., fmt="params")``)."""
    out = f"{path_prefix}-symbol.json"
    with open(out, "w") as f:
        f.write(symbol_json(cfg))
    return out


# ---------------------------------------------------------------------------
# Import: -symbol.json -> model config (the inverse of symbol_json)
# ---------------------------------------------------------------------------

def _node_attrs(node: dict) -> dict:
    """NNVM attr dict across MXNet json vintages (attrs/attr/param)."""
    for key in ("attrs", "attr", "param"):
        if key in node:
            return node[key]
    return {}


def _reverse_depth(units, bottleneck: bool, cifar: bool) -> int:
    # ImageNet-table depths first: a CIFAR-stem net can still use the
    # 4-stage table (e.g. the cifar10 depth-18 preset — registry rule)
    for depth, u in IMAGENET_UNITS.items():
        if tuple(units) == tuple(u) and (
                depth >= BOTTLENECK_MIN_DEPTH) == bottleneck:
            return depth
    if cifar and len(units) == 3 and len(set(units)) == 1:
        n = units[0]
        return 9 * n + 2 if bottleneck else 6 * n + 2
    raise ValueError(f"stage units {units} (bottleneck={bottleneck}, "
                     f"cifar={cifar}) match no known depth table")


def parse_symbol_json(txt: str) -> dict:
    """Infer the model configuration from an MXNet ``-symbol.json`` graph.

    The inverse of :func:`symbol_json` — so ``resnet_tpu_torch.tools.predict
    --load-epoch`` pointed at a foreign MXNet checkpoint pair (the
    ``mx.model.load_checkpoint`` layout, SURVEY.md §3.4) needs no
    hand-written ``--network/--depth/...`` flags: everything the symbol
    encodes is read back out of it. Structure read:

      - num_classes: the ``FullyConnected`` head's ``num_hidden``;
      - stem: first Convolution kernel (7,7)/stride 2 = ImageNet,
        (3,3)/stride 1 = CIFAR (selects ``dataset``);
      - residual units: ``stageN_unitM`` name scopes of the elemwise_add
        nodes (the naming this repo family uses — ref:symbol/resnet.py);
      - v1 vs v2: v1 units end in relu(add) — an Activation consuming an
        add output exists; v2 graphs have none (pre-activation);
      - bottleneck: a ``stage1_unit1_conv3`` node exists;
      - cardinality/group_width: ``num_group`` on the unit's 3x3 conv and
        the ResNeXt width rule inverted (gw = mid*256/(card*filters));
      - bn momentum/eps from the first non-fixed-gamma BatchNorm.

    Returns ``{"model": {...ModelConfig fields...}, "num_classes": int}``.
    Raises ValueError with a specific message on graphs outside this
    family (the reference repo only builds ResNet/ResNeXt symbols).
    """
    g = json.loads(txt)
    nodes = g["nodes"]
    by_name = {n["name"]: n for n in nodes}

    fcs = [n for n in nodes if n["op"] == "FullyConnected"]
    if not fcs:
        raise ValueError("symbol has no FullyConnected head")
    num_classes = int(_node_attrs(fcs[-1])["num_hidden"])

    convs = [n for n in nodes if n["op"] == "Convolution"]
    if not convs:
        raise ValueError("symbol has no Convolution nodes")
    stem = convs[0]
    stem_kernel = _node_attrs(stem).get("kernel", "")
    cifar = "3, 3" in stem_kernel or stem_kernel == "(3,3)"

    adds = [n for n in nodes
            if n["op"] in ("elemwise_add", "_Plus", "_plus", "add_n")]
    if not adds:
        raise ValueError("symbol has no residual add nodes")
    stage_units: dict = {}
    for n in adds:
        m = re.match(r"stage(\d+)_unit(\d+)", n["name"])
        if not m:
            raise ValueError(
                f"residual add node {n['name']!r} is not stageN_unitM-"
                "named; structural unit inference is not implemented for "
                "foreign naming schemes")
        s, u = int(m.group(1)), int(m.group(2))
        stage_units[s] = max(stage_units.get(s, 0), u)
    units = tuple(stage_units[s] for s in sorted(stage_units))

    bottleneck = "stage1_unit1_conv3" in by_name
    conv2 = by_name.get("stage1_unit1_conv2")
    cardinality = int(_node_attrs(conv2).get("num_group", 1)) if conv2 else 1
    network = "resnext" if cardinality > 1 else "resnet"
    group_width = 4
    if cardinality > 1:
        mid = int(_node_attrs(conv2)["num_filter"])
        out_f = int(_node_attrs(by_name["stage1_unit1_conv3"])["num_filter"])
        group_width = max(1, mid * 256 // (cardinality * out_f))

    # v1 iff some Activation consumes an add node's output
    add_idx = {nodes.index(n) for n in adds}
    version = 2
    for n in nodes:
        if n["op"] == "Activation" and any(
                i[0] in add_idx for i in n.get("inputs", [])):
            version = 1
            break

    bn_mom, bn_eps = 0.9, 2e-5
    for n in nodes:
        if n["op"] == "BatchNorm":
            a = _node_attrs(n)
            if str(a.get("fix_gamma", "False")).lower() in ("false", "0"):
                bn_mom = float(a.get("momentum", bn_mom))
                bn_eps = float(a.get("eps", bn_eps))
                break

    depth = _reverse_depth(units, bottleneck, cifar)
    return {
        "model": {
            "network": network,
            "depth": depth,
            "version": version,
            "cardinality": cardinality if network == "resnext" else 32,
            "group_width": group_width,
            "bn_mom": bn_mom,
            "bn_eps": bn_eps,
            "dataset": "cifar10" if cifar else "imagenet",
        },
        "num_classes": num_classes,
    }


def config_from_symbol(cfg: Config, path: str) -> Config:
    """Overlay a ``-symbol.json``'s model structure onto ``cfg``.

    Model-structure fields (network/depth/version/cardinality/group_width/
    bn_mom/bn_eps/dataset) and num_classes come from the symbol — the
    MXNet semantics of ``load_checkpoint`` (the graph travels WITH the
    checkpoint; the user does not re-specify it). Everything else
    (data pipeline, precision, lowering knobs) stays from ``cfg``.
    """
    with open(path) as f:
        info = parse_symbol_json(f.read())
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **info["model"]),
        data=dataclasses.replace(cfg.data,
                                 num_classes=info["num_classes"]))
