"""Minimal OmegaConf-compatible run config (the port's copy of
gslidar_tpu/config.py, same names and semantics).

The reference threads a single merged OmegaConf object through everything
(reference: train.py:749-756, configs/base.yaml):

* ``Config.load(path)``        — YAML file -> nested attr-accessible config
* ``Config.merge(a, b, ...)``  — recursive merge, later wins
* ``Config.from_cli(argv)``    — ``key=value`` / ``a.b.c=value`` dotlist,
                                 values parsed as YAML scalars/lists
* ``???`` mandatory-value marker raises on access
* ``Config.update(cfg, key, value)`` — dotted update
"""

from __future__ import annotations

import re
import sys
from typing import Any, Iterator, Mapping

import yaml

_MANDATORY = "???"


class _SciFloatLoader(yaml.SafeLoader):
    """SafeLoader that also accepts '1e-4'-style floats (YAML 1.1 requires a
    dot in the mantissa; the reference configs rely on the lenient form,
    e.g. configs/kitti360_nvs_1908.yaml:26 'densify_grad_threshold: 1e-4')."""


_SciFloatLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"""^(?:
        [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""", re.X),
    list("-+0123456789."))


def _yaml_load(stream):
    return yaml.load(stream, Loader=_SciFloatLoader)


class MissingMandatoryValue(Exception):
    pass


class Config(dict):
    """Nested dict with attribute access and OmegaConf-style helpers."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getitem__(self, key: str) -> Any:
        value = super().__getitem__(key)
        if isinstance(value, str) and value == _MANDATORY:
            raise MissingMandatoryValue(f"Missing mandatory value: {key}")
        return value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except (KeyError, MissingMandatoryValue):
            return default

    def items(self) -> Iterator:  # type: ignore[override]
        for k in self.keys():
            yield k, self.get(k)

    @staticmethod
    def load(path: str) -> "Config":
        with open(path, "r") as f:
            data = _yaml_load(f) or {}
        if not isinstance(data, dict):
            raise ValueError(f"Config root must be a mapping: {path}")
        return Config(data)

    @staticmethod
    def merge(*configs: Mapping[str, Any]) -> "Config":
        out = Config()
        for cfg in configs:
            _merge_into(out, cfg)
        return out

    @staticmethod
    def from_cli(argv: list[str] | None = None) -> "Config":
        """Parse ``a.b=value`` overrides from argv (non-flag args with '=')."""
        if argv is None:
            argv = sys.argv[1:]
        out = Config()
        for arg in argv:
            if "=" not in arg or arg.startswith("-"):
                continue
            key, _, raw = arg.partition("=")
            Config.update(out, key.strip(),
                          _yaml_load(raw) if raw != "" else None)
        return out

    @staticmethod
    def update(cfg: "Config", key: str, value: Any) -> None:
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            nxt = dict.get(node, p)
            if not isinstance(nxt, Config):
                nxt = Config()
                dict.__setitem__(node, p, nxt)
            node = nxt
        node[parts[-1]] = value


def _merge_into(dst: Config, src: Mapping[str, Any]) -> None:
    for k, v in dict.items(src) if isinstance(src, dict) else src.items():
        cur = dict.get(dst, k)
        if isinstance(v, Mapping) and isinstance(cur, Config):
            _merge_into(cur, v)
        else:
            dst[k] = v


def load_run_config(base_path: str, config_path: str,
                    cli_overrides: list[str] | None = None) -> Config:
    """3-layer merge identical to the reference entry point
    (reference: train.py:749-752): base.yaml <- scene yaml <- CLI dotlist."""
    return Config.merge(
        Config.load(base_path),
        Config.load(config_path),
        Config.from_cli(cli_overrides),
    )
