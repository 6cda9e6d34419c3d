"""Hydra-compatible configuration composer.

The reference drives everything through Hydra 1.3 + OmegaConf
(reference conf/*, train.py:775).  This module implements the subset the
segment CLI needs, preserving the user-facing surface:

  * app configs with ``defaults`` lists selecting group files
    (``conf/segment.yaml``) — including CLI group selection ``algorithm=dac``;
  * dotted-path CLI overrides ``a.b.c=value`` (+``+a=v`` to add new keys);
  * ``${...}`` interpolation: absolute paths from the config root,
    ``${.sibling}`` relative paths, and ``${hydra:runtime.cwd}``;
  * ``???`` mandatory values that raise when accessed unresolved;
  * deep merge (training-run config + CLI config, reference segment.py:161-163).

The port's copy of ``compose``, ``load_config``, ``merge``, ``resolve`` and
``to_plain`` of ``wav2vecsegmenter_tpu/config/config.py``
(tests/test_torch_copies.py holds the two equal).  pyyaml is imported where
a file or an override value is parsed, so the module imports without it.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

MISSING = "???"
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class MissingMandatoryValue(Exception):
    pass


class _MissingInterp(Exception):
    """Internal: an interpolation reached a ??? value (resolve() turns the
    whole interpolating string into MISSING)."""


class Config(dict):
    """dict with attribute access, dotted-path get/set, and ??? handling."""

    def __getattr__(self, key: str) -> Any:
        try:
            val = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(val, str) and val == MISSING:
            raise MissingMandatoryValue(f"Mandatory value '{key}' is not set")
        return val

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get(self, key, default=None):
        val = super().get(key, default)
        if isinstance(val, str) and val == MISSING:
            return default
        return val

    # dotted paths -----------------------------------------------------
    def select(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        if isinstance(node, str) and node == MISSING:
            return default
        return node

    def update_path(self, path: str, value: Any, create: bool = True) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                if not create:
                    raise KeyError(path)
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Config):
        return obj
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def to_plain(obj: Any) -> Any:
    """Config tree -> plain dict/list (OmegaConf.to_object equivalent)."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    return obj


def merge(base: Any, override: Any) -> Any:
    """Deep merge; override wins; dicts merge recursively, lists replace."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = Config(dict(base))
        for k, v in override.items():
            if k in out:
                out[k] = merge(out[k], v)
            else:
                out[k] = _wrap(v)
        return out
    return _wrap(override)


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML scalar rules.

    Collections are accepted only in flow style (``[a,b]`` / ``{a: 1}``),
    matching Hydra's override grammar — YAML *block* constructs that a
    scalar can accidentally trigger (``wav_path=-`` parses as ``[None]``
    under full YAML) stay plain strings."""
    import yaml

    if text == "":
        return None
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if (isinstance(value, (list, dict))
            and not text.lstrip().startswith(("[", "{"))):
        return text
    return value


def _load_yaml_file(path: Path) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return _wrap(data or {})


def _resolve_group_file(config_dir: Path, group: str, name: str) -> Path | None:
    """Find conf/<group>/<name>.yaml; fall back to progressively stripping
    trailing _<suffix> from the group (so ``st_eval_online: inference_pthr``
    resolves in conf/st_eval/, matching the reference's defaults list,
    reference conf/train.yaml:5-6)."""
    candidates = [group]
    g = group
    while "_" in g:
        g = g.rsplit("_", 1)[0]
        candidates.append(g)
    for cand in candidates:
        p = config_dir / cand / f"{name}.yaml"
        if p.exists():
            return p
    return None


def _compose_file(config_dir: Path, path: Path) -> Config:
    """Load a group file, processing any nested ``defaults`` list it carries
    (e.g. conf/st_eval/*.yaml select their own algorithm/infer_data groups,
    reference conf/st_eval/inference_dac.yaml:1-5)."""
    node = _load_yaml_file(path)
    defaults = node.pop("defaults", None)
    if not defaults:
        return node
    out = Config()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            out = merge(out, node)
            self_merged = True
            continue
        (group, name), = entry.items()
        if name is None:
            out[group] = None
            continue
        sub = _resolve_group_file(config_dir, group, str(name))
        if sub is None:
            raise FileNotFoundError(
                f"Config group file not found: {group}/{name}.yaml under {config_dir}"
            )
        out[group] = _compose_file(config_dir, sub)
    if not self_merged:
        out = merge(out, node)
    return out


def compose(
    config_dir: str | Path,
    config_name: str,
    overrides: list[str] | None = None,
    resolve_interp: bool = True,
) -> Config:
    """Compose an app config from its defaults list plus CLI overrides."""
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    app_cfg = _load_yaml_file(config_dir / f"{config_name}.yaml")
    defaults = app_cfg.pop("defaults", ["_self_"])

    # split overrides into group selections vs value overrides
    group_names = {
        next(iter(d.keys())) for d in defaults if isinstance(d, dict)
    }
    group_sel: dict[str, Any] = {}
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must be key=value")
        key, _, raw = ov.partition("=")
        add = key.startswith("+")
        key = key.lstrip("+")
        if key in group_names and "." not in key:
            group_sel[key] = _parse_value(raw)
        else:
            value_overrides.append((key, _parse_value(raw)))

    cfg = Config()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            cfg = merge(cfg, app_cfg)
            self_merged = True
            continue
        if not isinstance(entry, dict):
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
        (group, name), = entry.items()
        if group in group_sel:
            name = group_sel[group]
        if name is None:
            cfg[group] = None
            continue
        path = _resolve_group_file(config_dir, group, str(name))
        if path is None:
            raise FileNotFoundError(
                f"Config group file not found: {group}/{name}.yaml under {config_dir}"
            )
        cfg[group] = _compose_file(config_dir, path)
    if not self_merged:
        cfg = merge(cfg, app_cfg)

    for key, value in value_overrides:
        cfg.update_path(key, value)

    # hydra-style run-dir interpolation: the CLI layer injects the real
    # ${hydra.job.override_dirname} (cli/segment.main); default it so
    # direct compose() callers still resolve app configs with hydra blocks
    if "hydra" in cfg and cfg.select("hydra.job.override_dirname") is None:
        cfg.update_path("hydra.job.override_dirname", "")

    if resolve_interp:
        cfg = resolve(cfg)
    return cfg


def resolve(cfg: Config, _root: Config | None = None) -> Config:
    """Resolve ${...} interpolations in-place-ish (returns a new tree)."""
    root = cfg if _root is None else _root

    def _resolve_str(s: str, parent: dict) -> Any:
        def lookup(expr: str) -> Any:
            expr = expr.strip()
            if expr.startswith("hydra:"):
                tail = expr.split(":", 1)[1]
                if tail in ("runtime.cwd", "run.dir"):
                    return os.getcwd()
                if tail.startswith("job."):
                    return ""
                raise KeyError(f"Unsupported hydra resolver: {expr}")
            if expr.startswith("oc.env:"):
                return os.environ.get(expr.split(":", 1)[1], "")
            if expr.startswith("."):
                node: Any = parent
                path = expr[1:]
            else:
                node = root
                path = expr
            for part in path.split("."):
                if not isinstance(node, dict) or part not in node:
                    raise KeyError(f"Interpolation '{expr}' not found")
                node = node[part]
            if isinstance(node, str) and node == MISSING:
                raise _MissingInterp(expr)
            return node

        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation: preserve type
            val = lookup(m.group(1))
            if isinstance(val, str):
                val = _resolve_str(val, parent)
            return val
        return _INTERP_RE.sub(lambda mm: str(_resolve_str("${%s}" % mm.group(1), parent)), s)

    def walk(node: Any, parent: dict) -> Any:
        if isinstance(node, dict):
            out = Config()
            for k, v in node.items():
                out[k] = walk(v, node)
            return out
        if isinstance(node, list):
            return [walk(v, parent) for v in node]
        if isinstance(node, str) and "${" in node:
            try:
                return _resolve_str(node, parent)
            except _MissingInterp:
                # OmegaConf parity: a string interpolating a ??? is itself
                # missing — it surfaces as MissingMandatoryValue on access
                # (and as None via .get), never as a literal '???' leaking
                # into run-directory paths
                return MISSING
        return node

    return walk(cfg, cfg)


def load_config(path: str | Path, resolve_interp: bool = False) -> Config:
    cfg = _load_yaml_file(Path(path))
    return resolve(cfg) if resolve_interp else cfg
