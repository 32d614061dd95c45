"""One configuration system: dataclass-first, file-overridable.

Counterpart of ``gcn_grabcut_tpu/config.py``: a single ``FrameworkConfig``
nests the per-layer dataclasses (the port's ``SuperpixelGraphConfig``,
``GrabCutConfig`` and ``TrainConfig``, whose fields and defaults are the
JAX package's), is saved to and loaded from YAML or JSON -- a file either
package wrote loads in the other -- and any value can be overridden with
dotted keys (``train.lr=3e-4``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from .grabcut import GrabCutConfig
from .graph_build import SuperpixelGraphConfig
from .train.trainer import TrainConfig


@dataclasses.dataclass
class ModelConfig:
    variant: str = "resgcn"           # resgcn | gcn | gat
    hidden_channels: int = 128
    n_layers: int = 6
    n_classes: int = 3
    dropout: float = 0.2


@dataclasses.dataclass
class InferenceConfig:
    threshold: float = 0.65
    filter_radius: int = 4
    refine_iters: int = 0
    min_area_ratio: float = 0.002
    keep_largest: bool = False
    edge_aware: bool = True
    max_size: int = 512


@dataclasses.dataclass
class FrameworkConfig:
    superpixels: SuperpixelGraphConfig = dataclasses.field(
        default_factory=SuperpixelGraphConfig)
    grabcut: GrabCutConfig = dataclasses.field(
        default_factory=GrabCutConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    inference: InferenceConfig = dataclasses.field(
        default_factory=InferenceConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        data = self.to_dict()
        if path.suffix in (".yaml", ".yml"):
            import yaml
            path.write_text(yaml.safe_dump(data, sort_keys=False))
        else:
            path.write_text(json.dumps(data, indent=2))

    @classmethod
    def load(cls, path: Optional[str | Path] = None,
             overrides: Optional[dict[str, Any] | list[str]] = None
             ) -> "FrameworkConfig":
        """Build from defaults, then a file, then dotted-key overrides.

        `overrides` may be a dict {"train.lr": 3e-4} or a list of
        "train.lr=3e-4" strings (CLI-friendly).  An unknown section or
        field raises KeyError.
        """
        cfg = cls()
        if path is not None:
            path = Path(path)
            if path.suffix in (".yaml", ".yml"):
                import yaml
                data = yaml.safe_load(path.read_text()) or {}
            else:
                data = json.loads(path.read_text())
            _apply_nested(cfg, data)
        if overrides:
            if isinstance(overrides, list):
                parsed = {}
                for item in overrides:
                    k, _, v = item.partition("=")
                    parsed[k.strip()] = _parse_value(v.strip())
                overrides = parsed
            for key, val in overrides.items():
                _set_dotted(cfg, key, val)
        return cfg


def _apply_nested(cfg: Any, data: dict) -> None:
    for k, v in data.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config section/field: {k!r}")
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_nested(cur, v)
        else:
            _set_field(cfg, k, v)


def _set_dotted(cfg: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config section: {p!r} in {dotted!r}")
        obj = getattr(obj, p)
    _set_field(obj, parts[-1], value)


def _set_field(obj: Any, name: str, value: Any) -> None:
    """Set one field, cast to the type of its current value where that
    cast works (a list read from JSON becomes the default's tuple); a
    frozen dataclass (SuperpixelGraphConfig) is set through
    object.__setattr__."""
    if not hasattr(obj, name):
        raise KeyError(f"unknown config field: {name!r} on "
                       f"{type(obj).__name__}")
    current = getattr(obj, name)
    if current is not None and not isinstance(value, type(current)):
        try:
            value = type(current)(value)
        except (TypeError, ValueError):
            pass
    if dataclasses.is_dataclass(obj) and getattr(
            type(obj), "__dataclass_params__").frozen:
        object.__setattr__(obj, name, value)
    else:
        setattr(obj, name, value)


def _parse_value(s: str) -> Any:
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s
