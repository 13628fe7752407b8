"""Lazy config system: executable Python configs building a deferred object
graph, materialized by `instantiate`.

An own copy of ``detrpose_tpu/core/lazy.py``. It loads the repository's
``configs/{coco,crowdpose}/*.py`` (plain Python that imports nothing of
either package). ``save`` writes JSON, which is valid YAML, so saving needs no
PyYAML; loading a ``.yaml`` reads JSON first and needs PyYAML only for other
YAML.

Reference semantics: src/core/lazy.py (LazyCall :24-57, LazyConfig.load :196,
apply_overrides :316) and src/core/instantiate.py:37-88 — reimplemented
dependency-free (no omegaconf/hydra): a LazyCall produces a plain dict with a
``_target_`` key; configs are ordinary Python files executed in a module
namespace; CLI overrides use dotted ``a.b.c=value`` assignments with Python
literal values.
"""
from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import os
import pydoc
import uuid
from typing import Any, List, Mapping


class LazyCall:
    """L(Callable)(**kwargs) -> {'_target_': Callable, **kwargs} (deferred)."""

    def __init__(self, target):
        if not callable(target) and not isinstance(target, str):
            raise TypeError(f"LazyCall target must be callable, got {target!r}")
        self._target = target

    def __call__(self, **kwargs):
        d = {"_target_": self._target}
        d.update(kwargs)
        return ConfigDict(d)


class ConfigDict(dict):
    """dict with attribute access, so configs read like the reference's."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def locate(name: str) -> Any:
    """Dotted path -> python object (reference: src/core/utils.py:33-53)."""
    obj = pydoc.locate(name)
    if obj is None:
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            try:
                mod = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            obj = mod
            for p in parts[i:]:
                obj = getattr(obj, p)
            return obj
        raise ImportError(f"cannot locate {name!r}")
    return obj


def instantiate(cfg: Any) -> Any:
    """Recursively build objects from ``_target_`` trees (instantiate.py:37-88)."""
    if isinstance(cfg, Mapping) and "_target_" in cfg:
        kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
        target = cfg["_target_"]
        if isinstance(target, str):
            target = locate(target)
        return target(**kwargs)
    if isinstance(cfg, Mapping):
        return {k: instantiate(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    return cfg


class LazyConfig:
    """Load/save/override config files.

    Python configs are executed in a module namespace (reference
    lazy.py:196-248); ``.yaml`` files round-trip the same tree (reference
    save :250-303, yaml load :214-220), written as JSON.
    """

    @staticmethod
    def load(path: str) -> ConfigDict:
        path = os.path.abspath(path)
        if path.endswith((".yaml", ".yml", ".json")):
            with open(path) as f:
                text = f.read()
            try:
                return _wrap(json.loads(text))
            except json.JSONDecodeError:
                import yaml

                return _wrap(yaml.safe_load(text))
        spec = importlib.util.spec_from_file_location(
            f"_lazyconfig_{uuid.uuid4().hex}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = ConfigDict()
        for k, v in vars(mod).items():
            if k.startswith("_"):
                continue
            if isinstance(v, (dict, list, tuple, int, float, str, bool)) or v is None:
                cfg[k] = _wrap(v)
        return cfg

    @staticmethod
    def save(cfg: Mapping, path: str) -> None:
        """Serialize a config tree as JSON, which YAML readers read too
        (reference lazy.py:250-303 writes YAML).

        Callable ``_target_`` values are stored as their dotted import path so
        the file round-trips through ``load`` + ``instantiate``; a tree with a
        leaf JSON cannot hold is pickled next to the file instead, like the
        reference's cloudpickle fallback (:295-303).
        """
        def to_plain(v):
            if isinstance(v, Mapping):
                out = {}
                for k, x in v.items():
                    if k == "_target_" and callable(x):
                        x = f"{x.__module__}.{x.__qualname__}"
                    out[k] = to_plain(x)
                return out
            if isinstance(v, (list, tuple)):
                return [to_plain(x) for x in v]
            return v

        try:
            text = _to_json(to_plain(cfg))
        except (TypeError, ValueError):
            import pickle

            with open(path + ".pkl", "wb") as f:
                pickle.dump(cfg, f)
            return
        with open(path, "w") as f:
            f.write(text + "\n")

    @staticmethod
    def apply_overrides(cfg: ConfigDict, overrides: List[str]) -> ConfigDict:
        """Apply ``a.b.c=value`` overrides (values parsed as python literals)."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be key=value: {ov!r}")
            key, _, raw = ov.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node = cfg
            parts = key.strip().split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value
        return cfg


def _to_json(v, indent: str = "") -> str:
    """JSON text of a plain tree that YAML 1.1 readers (PyYAML) read back
    equal: a float in exponent form keeps a '.' in its mantissa ("1.0e-05";
    PyYAML reads "1e-05" as a string). Raises TypeError on a leaf JSON cannot
    hold and ValueError on a non-finite float."""
    inner = indent + "  "
    if isinstance(v, Mapping):
        if not v:
            return "{}"
        if not all(isinstance(k, str) for k in v):
            raise TypeError("config keys must be strings")
        items = [f"{inner}{json.dumps(k)}: {_to_json(x, inner)}" for k, x in v.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(v, list):
        if not v:
            return "[]"
        return "[\n" + ",\n".join(inner + _to_json(x, inner) for x in v) + "\n" + indent + "]"
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            raise ValueError(f"non-finite float {v} in a config")
        r = repr(v)
        mant, e, exp = r.partition("e")
        return f"{mant}.0e{exp}" if e and "." not in mant else r
    if v is None or isinstance(v, (bool, int, str)):
        return json.dumps(v)
    raise TypeError(f"a config leaf of type {type(v).__name__} is not JSON")


def _wrap(v):
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict({k: _wrap(x) for k, x in v.items()})
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


L = LazyCall
