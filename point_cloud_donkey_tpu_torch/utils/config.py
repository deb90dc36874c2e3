"""Reader and writer of the reference's `.ism` JSON configs (port of
point_cloud_donkey_tpu/utils/config.py without the template).

An `.ism` file is ``{"ObjectConfig": {"Type", "Parameters", "Children"}}``,
children nested the same way.  A parameter resolves against the default its
reader registers (``get(name, default)``): missing keys take the default,
present ones are coerced to the default's type, unknown keys are ignored.
A config without GlobalFeatures gets the Dummy descriptor
(implicit_shape_model.cpp:1106-1114), as in the JAX package, so both save
the same file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict


class ConfigError(ValueError):
    pass


def _coerce(value: Any, default: Any) -> Any:
    """Coerce a JSON value to the type of its default (the reference's
    JSONParameterTraits<T>)."""
    if default is None:
        return value
    if isinstance(default, bool):
        if isinstance(value, bool):
            return value
        raise ConfigError(f"expected bool, got {value!r}")
    if isinstance(default, int):
        if isinstance(value, bool):
            raise ConfigError(f"expected int, got bool {value!r}")
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, str):
        return str(value)
    return value


@dataclass
class ComponentConfig:
    """One node of the config tree: a `Type` string, its parameters and its
    named children."""

    type: str = ""
    params: Dict[str, Any] = field(default_factory=dict)
    children: Dict[str, "ComponentConfig"] = field(default_factory=dict)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "ComponentConfig":
        if obj is None:
            return cls()
        children = {name: cls.from_json(child)
                    for name, child in (obj.get("Children") or {}).items()}
        return cls(type=str(obj.get("Type", "")),
                   params=dict(obj.get("Parameters") or {}),
                   children=children)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.children:
            out["Children"] = {k: v.to_json()
                               for k, v in self.children.items()}
        if self.params:
            out["Parameters"] = dict(self.params)
        if self.type:
            out["Type"] = self.type
        return out

    def get(self, name: str, default: Any) -> Any:
        """The parameter `name`, or `default` when the file has none."""
        if name not in self.params:
            return default
        try:
            return _coerce(self.params[name], default)
        except ConfigError as e:
            raise ConfigError(f"parameter {name!r}: {e}") from e

    def child(self, name: str) -> "ComponentConfig":
        return self.children.get(name, ComponentConfig())


@dataclass
class IsmConfig:
    """A whole `.ism` config: root parameters and named children (Codebook
    with ActivationStrategy, Keypoints, Features, Voting, ...)."""

    root: ComponentConfig = field(default_factory=ComponentConfig)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "IsmConfig":
        if "ObjectConfig" not in obj:
            raise ConfigError("missing ObjectConfig root key")
        cfg = cls(root=ComponentConfig.from_json(obj["ObjectConfig"]))
        if "GlobalFeatures" not in cfg.root.children:
            cfg.root.children["GlobalFeatures"] = ComponentConfig(
                type="Dummy")
        return cfg

    @classmethod
    def load(cls, path: str) -> "IsmConfig":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_json(self) -> Dict[str, Any]:
        return {"ObjectConfig": self.root.to_json()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=3, sort_keys=True)

    def child(self, name: str) -> ComponentConfig:
        return self.root.child(name)
