"""Config loading (counterpart of `gsdx/io/config.py`).

The three blocks of a reference-format YAML file (train_config /
model_config / dataset_config) become the typed configs used across the
port. The file is read by a small parser of its own, not PyYAML: it takes
the subset the configs under `configs/` use (block maps, block sequences,
flow lists `[a, b]`, plain and quoted scalars, comments) and resolves
scalars as `yaml.safe_load` does (YAML 1.1 booleans, null, decimal ints,
floats with a dot). Anything outside that subset raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
# PyYAML's implicit float: a dot is required ("1e-3" stays a string)
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


class _Line(NamedTuple):
    indent: int
    text: str
    number: int


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, number: int) -> Any:
    text = text.strip()
    if text[:1] in "\"'":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"line {number}: unterminated string {text!r}")
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body.replace(
            '\\"', '"').replace("\\\\", "\\")
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"line {number}: unterminated flow list {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(x, number) for x in _split_flow(inner)] if inner else []
    if text[:1] in "{&*!|>":
        raise ValueError(f"line {number}: unsupported YAML construct {text!r}")
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _split_flow(inner: str) -> List[str]:
    parts, depth, quote, cur = [], 0, None, ""
    for ch in inner:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    parts.append(cur)
    return [p.strip() for p in parts]


def _key_value(line: _Line):
    m = re.match(r"([^\s:\"'#][^:#]*?|\"[^\"]*\"|'[^']*')\s*:(\s+|$)", line.text)
    if not m:
        return None
    key = m.group(1)
    if key[:1] in "\"'":
        key = key[1:-1]
    return key, line.text[m.end():].strip()


def _parse_block(lines: List[_Line], i: int, indent: int):
    """Parse the node whose lines start at ``i`` with this indent; returns
    (value, index of the first line after it)."""
    if lines[i].text == "-" or lines[i].text.startswith("- "):
        items = []
        while (i < len(lines) and lines[i].indent == indent
               and (lines[i].text == "-" or lines[i].text.startswith("- "))):
            rest = lines[i].text[1:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1].indent > indent:
                    value, i = _parse_block(lines, i + 1, lines[i + 1].indent)
                else:
                    value, i = None, i + 1
            elif _key_value(_Line(0, rest, lines[i].number)) and not rest.startswith(("\"", "'", "[")):
                # "- key: value" opens a map whose keys sit two columns in
                inner = indent + 2
                lines[i] = _Line(inner, rest, lines[i].number)
                value, i = _parse_block(lines, i, inner)
            else:
                value, i = _scalar(rest, lines[i].number), i + 1
            items.append(value)
        return items, i

    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i].indent == indent:
        kv = _key_value(lines[i])
        if kv is None:
            raise ValueError(f"line {lines[i].number}: expected 'key: value', "
                             f"got {lines[i].text!r}")
        key, rest = kv
        if key in out:
            raise ValueError(f"line {lines[i].number}: duplicate key {key!r}")
        if rest:
            out[key], i = _scalar(rest, lines[i].number), i + 1
        elif i + 1 < len(lines) and (lines[i + 1].indent > indent or (
                lines[i + 1].indent == indent and lines[i + 1].text.startswith("- "))):
            out[key], i = _parse_block(lines, i + 1, lines[i + 1].indent)
        else:
            out[key], i = None, i + 1
    if i < len(lines) and lines[i].indent > indent:
        raise ValueError(f"line {lines[i].number}: unexpected indentation")
    return out, i


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {number}: tabs in indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("", "---"):
            continue
        lines.append(_Line(len(body) - len(body.lstrip()), body.strip(), number))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0].indent)
    if i != len(lines):
        raise ValueError(f"line {lines[i].number}: unexpected dedent")
    return value


def _pick(d: Dict[str, Any], mapping: Dict[str, str], cls, extra=None):
    kwargs = dict(extra or {})
    for yaml_key, field in mapping.items():
        if yaml_key in d:
            v = d[yaml_key]
            kwargs[field] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def load_config(path: str):
    """Parse a reference-format YAML (e.g. `configs/rope.yaml`) into
    (TrainConfig, ModelConfig, GraphDatasetConfig); a model_config with
    ``network: gns`` (`configs/gns_water3d.yaml`) into (TrainConfig,
    GNSConfig, the dataset block's first entry as it is)."""
    from gsdx_torch.dynamics.gns import GNSConfig
    from gsdx_torch.dynamics.model import ModelConfig
    from gsdx_torch.dynamics.train import TrainConfig
    from gsdx_torch.graph.dataset import GraphDatasetConfig

    with open(path) as f:
        raw = parse_yaml(f.read()) or {}

    tc = raw.get("train_config", {})
    mc = raw.get("model_config", {})
    dc_all = raw.get("dataset_config", {})
    dc = (dc_all.get("datasets") or [{}])[0]

    train_cfg = _pick(
        tc,
        {"batch_size": "batch_size", "n_epochs": "n_epochs",
         "log_interval": "log_interval", "random_seed": "random_seed",
         "n_his": "n_his", "n_future": "n_future", "mse_loss": "mse_weight",
         "length_loss": "length_weight", "out_dir": "out_dir",
         "dist_thresh": "dist_thresh", "lr": "lr"},
        TrainConfig,
        extra={
            "n_iters_per_epoch_train": tc.get("n_iters_per_epoch", {}).get("train", 100),
            "n_iters_per_epoch_valid": tc.get("n_iters_per_epoch", {}).get("valid", 10),
        },
    )
    if mc.get("network", "interaction") == "gns":
        model_cfg = _pick(mc, {k: k for k in GNSConfig._fields}, GNSConfig)
        return train_cfg, model_cfg._replace(bounds=tuple(map(tuple, model_cfg.bounds))), dc
    model_cfg = _pick(
        mc,
        {k: k for k in ("nf_particle", "nf_relation", "nf_effect", "attr_dim",
                        "state_dim", "action_dim", "pstep", "rel_attr_dim",
                        "rel_group_dim", "rel_distance_dim", "motion_dim")},
        ModelConfig,
        extra={"n_his": tc.get("n_his", 3)},
    )
    noise = dc.get("state_noise", {})
    dataset_cfg = _pick(
        dc,
        {k: k for k in ("max_nobj", "max_tool", "max_nR", "fps_radius_range",
                        "adj_radius_range", "topk", "connect_all")},
        GraphDatasetConfig,
        extra={
            "n_his": tc.get("n_his", 3),
            "n_future": tc.get("n_future", 5),
            "state_noise_train": noise.get("train", 0.003),
            "state_noise_valid": noise.get("valid", 0.0),
        },
    )
    return train_cfg, model_cfg, dataset_cfg
