"""YAML config composition, interpolation, overrides and instantiation.

The port's own copy of the JAX package's mini-Hydra
(pillarnext_tpu/utils/config.py:35-240), so the port reads the same YAML
tree without importing Python from the JAX package:

- ``defaults:`` lists with relative group paths, ``group@target: name``
  package redirection, and ``_self_`` ordering
- ``# @package <path>`` headers (``_global_`` or a dotted mount point)
- ``${a.b.c}`` and ``${a.b[1]}`` interpolation resolved against the root
- ``_target_`` node instantiation through a registry, honoring
  ``_partial_`` and ``_recursive_``
- dotted overrides ``a.b=v`` and additions ``+a.b=v``

Unlike the JAX package, ``instantiate`` resolves targets only through the
registry it is given (utils/registry.py: PORT_REGISTRY); an unknown target
raises.
"""

from __future__ import annotations

import copy
import functools
import re
from pathlib import Path
from typing import Any, Callable

import yaml

_PKG_RE = re.compile(r"^#\s*@package\s+(\S+)")
_INTERP_FULL_RE = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_PART_RE = re.compile(r"\$\{([^}]+)\}")


# ---------------------------------------------------------------- composition


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge; overlay wins; lists replace wholesale."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _mount(tree: Any, path: str | None) -> dict:
    """Wrap ``tree`` under a dotted mount path ('' / '_global_' = root)."""
    if not path or path == "_global_":
        return tree if isinstance(tree, dict) else {}
    for part in reversed(path.split(".")):
        tree = {part: tree}
    return tree


def _read_yaml(path: Path) -> tuple[dict, str | None]:
    """Load a YAML file; return (body, package header)."""
    text = path.read_text()
    pkg = None
    for line in text.splitlines():
        m = _PKG_RE.match(line.strip())
        if m:
            pkg = m.group(1)
            break
        if line.strip() and not line.strip().startswith("#"):
            break
    body = yaml.safe_load(text) or {}
    return body, pkg


def _load_composed(path: Path, mount: str | None) -> dict:
    """Load one config file, recursively composing its defaults list.

    Relative default entries resolve against the file's directory.  The
    ``group@pkg: name`` form mounts the group file under ``pkg`` relative to
    this file's own mount point.
    """
    body, pkg = _read_yaml(path)
    own_mount = pkg if pkg is not None else mount

    defaults = body.pop("defaults", None)
    own = _mount(body, own_mount)
    if defaults is None:
        return own

    merged: dict = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, own)
            self_seen = True
            continue
        if isinstance(entry, str):
            group, name, target = entry, None, None
        else:
            (group, name), = entry.items()
            target = None
        if "@" in group:
            group, target = group.split("@", 1)
        sub = path.parent / group
        sub_path = sub / f"{name}.yaml" if name else sub.with_suffix(".yaml")

        if target is not None:
            base_mount = "" if own_mount in (None, "_global_") else own_mount
            child_mount = target if not base_mount else f"{base_mount}.{target}"
        else:
            child_mount = own_mount
        merged = _deep_merge(merged, _load_composed(sub_path.resolve(), child_mount))
    if not self_seen:
        merged = _deep_merge(merged, own)
    return merged


def load_config(path: str | Path) -> dict:
    """Load + compose an experiment config file (no interpolation yet)."""
    return _load_composed(Path(path).resolve(), None)


# ---------------------------------------------------------------- overrides


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Apply ``a.b=v`` (must exist unless prefixed '+') dotted overrides."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, val = ov.split("=", 1)
        additive = key.startswith("+")
        key = key.lstrip("+")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                if not additive:
                    raise KeyError(f"override path {key!r}: missing {p!r}")
                node[p] = {}
            node = node[p]
        if not additive and parts[-1] not in node:
            raise KeyError(f"override key {key!r} not in config (use +{key})")
        node[parts[-1]] = yaml.safe_load(val)
    return cfg


# ------------------------------------------------------------- interpolation


def _lookup(root: Any, expr: str) -> Any:
    """Resolve 'a.b[1].c' against the root config."""
    node = root
    for token in re.findall(r"[^.\[\]]+|\[\d+\]", expr):
        if token.startswith("["):
            node = node[int(token[1:-1])]
        else:
            node = node[token]
    return node


def resolve(cfg: dict) -> dict:
    """Resolve all ``${...}`` interpolations (iteratively, to closure)."""
    root = copy.deepcopy(cfg)

    def _resolve_node(node: Any) -> tuple[Any, bool]:
        changed = False
        if isinstance(node, dict):
            for k, v in node.items():
                node[k], c = _resolve_node(v)
                changed |= c
            return node, changed
        if isinstance(node, list):
            for i, v in enumerate(node):
                node[i], c = _resolve_node(v)
                changed |= c
            return node, changed
        if isinstance(node, str):
            m = _INTERP_FULL_RE.match(node)
            if m:
                return copy.deepcopy(_lookup(root, m.group(1))), True
            if _INTERP_PART_RE.search(node):
                out = _INTERP_PART_RE.sub(lambda mm: str(_lookup(root, mm.group(1))), node)
                return out, True
        return node, False

    for _ in range(20):
        root, changed = _resolve_node(root)
        if not changed:
            return root
    raise ValueError("interpolation did not converge (cycle?)")


def load_experiment(path: str | Path, overrides: list[str] | None = None) -> dict:
    """Compose + override + resolve an experiment config."""
    cfg = load_config(path)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve(cfg)


# --------------------------------------------------------------- instantiate


def instantiate(node: Any, registry: dict[str, Callable], **extra) -> Any:
    """Instantiate a ``_target_`` config node through ``registry``.

    - ``_partial_: True`` returns a functools.partial
    - ``_recursive_: False`` leaves child dicts as plain config
    - extra kwargs override/augment the config's kwargs
    """
    if not isinstance(node, dict) or "_target_" not in node:
        return node
    node = dict(node)
    target = node.pop("_target_")
    partial = bool(node.pop("_partial_", False))
    recursive = bool(node.pop("_recursive_", True))

    kwargs = {}
    for k, v in node.items():
        if recursive and isinstance(v, dict) and "_target_" in v:
            kwargs[k] = instantiate(v, registry)
        elif recursive and isinstance(v, dict):
            kwargs[k] = {
                kk: instantiate(vv, registry) if isinstance(vv, dict) else vv
                for kk, vv in v.items()
            }
        else:
            kwargs[k] = v
    kwargs.update(extra)

    if target not in registry:
        raise KeyError(f"unknown _target_ {target!r}")
    fn = registry[target]
    if partial:
        return functools.partial(fn, **kwargs)
    return fn(**kwargs)
