"""Config system: Hydra-compatible YAML composition (copy of
``summer_clip_tpu/core/config.py``, pure Python + yaml).

This is a from-scratch, dependency-free re-implementation of the config
surface the reference relies on (Hydra 1.1/1.2 + OmegaConf), preserving the
*public config shape* so the reference's recipes carry over:

- ``defaults:`` lists with group composition, ``group@package`` redirects and
  ``_self_`` ordering (cf. reference ``summer_clip/conf/save_features.yaml``).
- ``${a.b.c}`` interpolation across the composed tree.
- ``_target_`` dotted-path instantiation (``hydra.utils.instantiate``).
- ``instantiate_all``: every list-valued field of a ``_target_`` node is a
  sweep axis; yields the cartesian product of instantiated objects — the
  in-process hyperparameter-search engine used by CLIP-search
  (reference ``summer_clip/utils/hydra_utils.py:38-50``).
- ``main(config_path, config_name)`` app decorator: CLI ``key=value``
  overrides, per-run output dir ``outputs/<date>/<time>/`` with
  ``.hydra/config.yaml`` + chdir semantics (reference ``conf/hydra_setup.yaml``).

Implementation is pure Python on top of PyYAML; no torch / hydra / omegaconf.
"""

from __future__ import annotations

import copy
import datetime
import functools
import importlib
import itertools
import os
import re
import sys
import typing as tp
from pathlib import Path

import yaml

__all__ = [
    "ConfigNode", "ConfigList", "load_config", "compose", "merge", "to_container",
    "to_yaml", "instantiate", "instantiate_all", "load_obj", "type_full_name",
    "main", "open_dict", "MISSING",
]

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


# ---------------------------------------------------------------------------
# Node wrappers (attribute-style access over plain dict/list containers)
# ---------------------------------------------------------------------------

class ConfigNode:
    """A dict-backed config node with attribute access and interpolation.

    Interpolation is resolved lazily against the root node, so values may
    reference keys anywhere in the composed tree (``${meta.random_state}``).
    """

    def __init__(self, data: tp.Optional[dict] = None, root: "ConfigNode | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", root)
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v, self._root_or_self())

    # -- internals ----------------------------------------------------------
    def _root_or_self(self) -> "ConfigNode":
        return self._root if self._root is not None else self

    def _rebind_root(self, root: "ConfigNode") -> None:
        object.__setattr__(self, "_root", root if root is not self else None)
        for v in self._data.values():
            if isinstance(v, (ConfigNode, ConfigList)):
                v._rebind_root(root)

    def _resolve_value(self, value: tp.Any) -> tp.Any:
        if isinstance(value, str):
            return _resolve_interp(value, self._root_or_self())
        return value

    # -- mapping protocol ----------------------------------------------------
    def __getattr__(self, key: str) -> tp.Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Missing config key: {key!r}") from e

    def __setattr__(self, key: str, value: tp.Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __getitem__(self, key: str) -> tp.Any:
        value = self._data[key]
        resolved = self._resolve_value(value)
        if isinstance(resolved, str) and resolved == MISSING:
            raise KeyError(f"Config key {key!r} is MISSING (???)")
        return resolved

    def __setitem__(self, key: str, value: tp.Any) -> None:
        self._data[key] = _wrap(value, self._root_or_self())

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def get(self, key: str, default: tp.Any = None) -> tp.Any:
        try:
            return self[key]
        except KeyError:
            return default

    def setdefault(self, key: str, default: tp.Any = None) -> tp.Any:
        if key not in self._data:
            self[key] = default
        return self[key]

    def update(self, other: tp.Union[dict, "ConfigNode"]) -> None:
        items = other.items() if not isinstance(other, dict) else other.items()
        for k, v in items:
            self[k] = v

    def pop(self, key: str, *default: tp.Any) -> tp.Any:
        if key in self._data:
            val = self[key]
            del self._data[key]
            return val
        if default:
            return default[0]
        raise KeyError(key)

    def copy(self) -> "ConfigNode":
        return ConfigNode(to_container(self, resolve=False))

    def __deepcopy__(self, memo) -> "ConfigNode":
        return self.copy()

    def __repr__(self) -> str:
        return f"ConfigNode({to_container(self, resolve=False)!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return to_container(self) == to_container(other)
        if isinstance(other, dict):
            return to_container(self) == other
        return NotImplemented


class ConfigList:
    """A list-backed config node; resolves interpolations on access."""

    def __init__(self, data: tp.Optional[list] = None, root: tp.Optional[ConfigNode] = None):
        self._root = root
        self._data: list = [_wrap(v, root) for v in (data or [])]

    def _rebind_root(self, root: ConfigNode) -> None:
        self._root = root
        for v in self._data:
            if isinstance(v, (ConfigNode, ConfigList)):
                v._rebind_root(root)

    def _resolve_value(self, value: tp.Any) -> tp.Any:
        if isinstance(value, str) and self._root is not None:
            return _resolve_interp(value, self._root)
        return value

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            out = ConfigList([], self._root)
            out._data = self._data[idx]
            return out
        return self._resolve_value(self._data[idx])

    def __setitem__(self, idx, value):
        self._data[idx] = _wrap(value, self._root)

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return (self._resolve_value(v) for v in self._data)

    def __contains__(self, item):
        return item in list(self)

    def append(self, value):
        self._data.append(_wrap(value, self._root))

    def __repr__(self):
        return f"ConfigList({to_container(self, resolve=False)!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (ConfigList, list)):
            return to_container(self) == (to_container(other) if isinstance(other, ConfigList) else other)
        return NotImplemented


def _wrap(value: tp.Any, root: tp.Optional[ConfigNode]) -> tp.Any:
    if isinstance(value, ConfigNode):
        value._rebind_root(root if root is not None else value)
        return value
    if isinstance(value, ConfigList):
        value._rebind_root(root)  # type: ignore[arg-type]
        return value
    if isinstance(value, dict):
        node = ConfigNode()
        object.__setattr__(node, "_root", root)
        for k, v in value.items():
            node._data[k] = _wrap(v, root if root is not None else node)
        return node
    if isinstance(value, (list, tuple)):
        return ConfigList(list(value), root)
    return value


def _select_path(root: ConfigNode, path: str) -> tp.Any:
    cur: tp.Any = root
    for part in path.split("."):
        if isinstance(cur, ConfigNode):
            cur = cur[part]
        elif isinstance(cur, ConfigList):
            cur = cur[int(part)]
        else:
            raise KeyError(path)
    return cur


def _eval_resolver(ref: str) -> tp.Optional[str]:
    """Built-in ``${now:FMT}`` resolver (hydra's run-dir timestamp idiom)."""
    if ref.startswith("now:"):
        return datetime.datetime.now().strftime(ref[len("now:"):])
    return None


def _resolve_interp(value: str, root: ConfigNode, _depth: int = 0) -> tp.Any:
    if _depth > 16:
        raise RecursionError(f"Interpolation loop while resolving {value!r}")
    full = _INTERP_RE.fullmatch(value)
    if full:
        ref = full.group(1).strip()
        resolved = _eval_resolver(ref)
        if resolved is not None:
            return resolved
        # whole-string interpolation keeps the referenced value's type
        return _select_path(root, ref)

    def sub(m: re.Match) -> str:
        ref = m.group(1).strip()
        resolved = _eval_resolver(ref)
        if resolved is not None:
            return resolved
        return str(_select_path(root, ref))

    out = _INTERP_RE.sub(sub, value)
    if out != value and _INTERP_RE.search(out):
        return _resolve_interp(out, root, _depth + 1)
    return out


def to_container(cfg: tp.Any, resolve: bool = True) -> tp.Any:
    """Convert a config tree back to plain dict/list containers."""
    if isinstance(cfg, ConfigNode):
        if resolve:
            return {k: to_container(cfg[k], resolve) for k in cfg}
        return {k: to_container(cfg._data[k], resolve) for k in cfg}
    if isinstance(cfg, ConfigList):
        if resolve:
            return [to_container(v, resolve) for v in cfg]
        return [to_container(v, resolve) for v in cfg._data]
    return cfg


def to_yaml(cfg: tp.Any, resolve: bool = False) -> str:
    return yaml.safe_dump(to_container(cfg, resolve=resolve), sort_keys=False)


class open_dict:
    """No-op context manager kept for API parity with ``omegaconf.open_dict``."""

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg

    def __enter__(self) -> ConfigNode:
        return self.cfg

    def __exit__(self, *exc) -> None:
        return None


# ---------------------------------------------------------------------------
# Merge / composition
# ---------------------------------------------------------------------------

def merge(base: tp.Any, override: tp.Any) -> tp.Any:
    """Deep-merge plain containers; override wins; dicts merge recursively."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = merge(out[k], v) if k in out else copy.deepcopy(v)
        return out
    return copy.deepcopy(override)


def _set_path(tree: dict, path: str, value: tp.Any, *, merge_dicts: bool = True) -> None:
    parts = path.split(".")
    cur = tree
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    last = parts[-1]
    if merge_dicts and isinstance(cur.get(last), dict) and isinstance(value, dict):
        cur[last] = merge(cur[last], value)
    else:
        cur[last] = value


def _load_yaml_file(path: Path) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _find_group_file(conf_dir: Path, group: str, option: str) -> Path:
    candidates = [
        conf_dir / group / f"{option}.yaml",
        conf_dir / group / f"{option}.yml",
        conf_dir / f"{option}.yaml",  # group-less entries
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"Config group option not found: group={group!r} option={option!r} under {conf_dir}"
    )


def _compose_file(conf_dir: Path, rel_name: str, package: tp.Optional[str] = None) -> dict:
    """Compose one yaml file (recursively processing its ``defaults:`` list).

    Returns a plain dict. ``package`` prefixes the file's own content
    (``group@pkg`` redirect semantics).
    """
    path = conf_dir / f"{rel_name}.yaml"
    if not path.exists():
        path = conf_dir / rel_name
    raw = _load_yaml_file(path)
    defaults = raw.pop("defaults", None)

    own: dict = raw
    if package and package != "_global_":
        for part in reversed(package.split(".")):
            own = {part: own}

    if defaults is None:
        return own

    tree: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            tree = merge(tree, own)
            self_merged = True
            continue
        if isinstance(entry, str):
            # bare file include (same dir or path-like)
            sub = _compose_file(conf_dir, entry)
            tree = merge(tree, sub)
            continue
        if isinstance(entry, dict):
            (key, option), = entry.items()
            optional = False
            if key.startswith("optional "):
                optional = True
                key = key[len("optional "):]
            if option is None:
                continue
            if "@" in key:
                group, pkg = key.split("@", 1)
            else:
                group, pkg = key, key.lstrip("/").replace("/", ".")
            group = group.lstrip("/")  # `/group:` = absolute group reference
            try:
                gfile = _find_group_file(conf_dir, group, str(option))
            except FileNotFoundError:
                if optional:
                    continue
                raise
            sub_rel = gfile.relative_to(conf_dir)
            sub = _compose_file(conf_dir, str(sub_rel.with_suffix("")))
            if pkg == "_global_":
                tree = merge(tree, sub)
            else:
                subtree: dict = {}
                _set_path(subtree, pkg, sub)
                tree = merge(tree, subtree)
            continue
        raise ValueError(f"Unsupported defaults entry: {entry!r}")

    if not self_merged:
        tree = merge(tree, own)
    return tree


def _parse_override_value(text: str) -> tp.Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def compose(conf_dir: tp.Union[str, Path], config_name: str,
            overrides: tp.Optional[tp.Sequence[str]] = None) -> ConfigNode:
    """Compose a config from a conf dir + entry-point name + CLI overrides."""
    conf_dir = Path(conf_dir)
    tree = _compose_file(conf_dir, config_name)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must look like key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        key = key.lstrip("+~")
        # group override with package redirect: `dataset@cache.dataset=mnist`
        if "@" in key:
            group, pkg = key.split("@", 1)
            gfile = conf_dir / group / f"{val}.yaml"
            if gfile.exists():
                sub = _compose_file(conf_dir, f"{group}/{val}")
                # group re-selection REPLACES the previous selection (hydra semantics)
                _set_path(tree, pkg, sub, merge_dicts=False)
                continue
        # plain group override: `dataset=cifar10` where conf/dataset/cifar10.yaml exists
        group_candidate = conf_dir / key / f"{val}.yaml"
        if group_candidate.exists():
            sub = _compose_file(conf_dir, f"{key}/{val}")
            _set_path(tree, key.replace("/", "."), sub, merge_dicts=False)
        else:
            _set_path(tree, key, _parse_override_value(str(val)), merge_dicts=False)
    return ConfigNode(tree)


def load_config(conf_dir: tp.Union[str, Path], config_name: str,
                overrides: tp.Optional[tp.Sequence[str]] = None) -> ConfigNode:
    return compose(conf_dir, config_name, overrides)


# ---------------------------------------------------------------------------
# Instantiation (reference: hydra.utils.instantiate + hydra_utils.load_obj)
# ---------------------------------------------------------------------------

def load_obj(obj_path: str, default_obj_path: str = "") -> tp.Any:
    """Dotted-path import, e.g. ``summer_clip_torch.methods.cache.TopKStrategy``.

    Mirrors reference ``summer_clip/utils/hydra_utils.py:9-26``.
    """
    obj_path_list = obj_path.rsplit(".", 1)
    obj_path = obj_path_list.pop(0) if len(obj_path_list) > 1 else default_obj_path
    obj_name = obj_path_list[0]
    module_obj = importlib.import_module(obj_path)
    if not hasattr(module_obj, obj_name):
        raise AttributeError(f"Object `{obj_name}` cannot be loaded from `{obj_path}`.")
    return getattr(module_obj, obj_name)


def type_full_name(type_: tp.Optional[type]) -> tp.Optional[str]:
    if type_ is None:
        return None
    module = type_.__module__
    if module is None or module == str.__module__:
        return type_.__name__
    return f"{module}.{type_.__name__}"


def instantiate(cfg: tp.Any, *args: tp.Any, **kwargs: tp.Any) -> tp.Any:
    """Instantiate a ``_target_`` config node (recursively).

    Supports ``_partial_: true`` (returns functools.partial) and
    ``_args_`` positional arguments; nested ``_target_`` dicts are
    instantiated depth-first, matching hydra.utils.instantiate semantics.
    """
    if isinstance(cfg, (ConfigNode, ConfigList)):
        cfg = to_container(cfg, resolve=True)
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}

    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial = bool(cfg.pop("_partial_", False))
    pos = [instantiate(v) for v in cfg.pop("_args_", [])] + list(args)
    call_kwargs = {
        k: (instantiate(v) if isinstance(v, (dict, list)) else v)
        for k, v in cfg.items()
    }
    call_kwargs.update(kwargs)
    fn = load_obj(target) if isinstance(target, str) else target
    if partial:
        return functools.partial(fn, *pos, **call_kwargs)
    return fn(*pos, **call_kwargs)


def instantiate_all(cfg: tp.Any) -> tp.Generator[tp.Tuple[tp.Any, tp.Dict[str, tp.Any]], None, None]:
    """Cartesian sweep over all list-valued fields of a ``_target_`` node.

    Yields ``(instantiated_object, param_dict)`` pairs — semantics of
    reference ``summer_clip/utils/hydra_utils.py:38-50`` where every
    list-valued leaf is a sweep axis (e.g. ``topk: [1, 2, 4]``).
    """
    cfg_dict = to_container(cfg, resolve=True) if isinstance(cfg, (ConfigNode, ConfigList)) else copy.deepcopy(cfg)
    assert isinstance(cfg_dict, dict) and "_target_" in cfg_dict, "instantiate_all needs a _target_ node"
    target = cfg_dict.pop("_target_")
    sweep_keys = list(cfg_dict.keys())
    sweep_values = [v if isinstance(v, list) else [v] for v in cfg_dict.values()]

    for combo in itertools.product(*sweep_values):
        params = dict(zip(sweep_keys, combo))
        obj = instantiate({"_target_": target, **params})
        yield obj, {"_target_": target, **params}


# ---------------------------------------------------------------------------
# App entry-point decorator (reference: @hydra.main + conf/hydra_setup.yaml)
# ---------------------------------------------------------------------------

def _make_run_dir(base: tp.Union[str, Path] = "outputs",
                  pattern: tp.Optional[str] = None) -> Path:
    """Create a fresh run dir; ``pattern`` is a resolved ``hydra.run.dir``
    value (relative patterns are rooted at ``base``'s parent = the launch cwd)."""
    now = datetime.datetime.now()
    if pattern is not None:
        run_dir = Path(pattern)
        if not run_dir.is_absolute():
            run_dir = Path(base).parent / run_dir
    else:
        run_dir = Path(base) / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")
    first = run_dir
    suffix = 0
    while True:   # ranks of one launch may reach the same name at once
        try:
            run_dir.mkdir(parents=True)
            return run_dir
        except FileExistsError:
            suffix += 1
            run_dir = first.with_name(f"{first.name}-{suffix}")


def main(config_path: tp.Union[str, Path], config_name: str,
         version_base: tp.Optional[str] = None, chdir: tp.Optional[bool] = None):
    """App decorator: compose config from CLI args, create a run dir, call fn.

    Mirrors the reference launch contract (``conf/hydra_setup.yaml``): each
    run executes in a fresh run dir containing ``.hydra/config.yaml``. The
    composed config's ``hydra:`` node is honored and stripped before the app
    sees the config, exactly like hydra itself:

    - ``hydra.job.chdir``   — chdir into the run dir for the app's duration
      (reference ``conf/hydra_setup.yaml:2-3``); the decorator's ``chdir``
      argument, when not None, overrides it.
    - ``hydra.run.dir``     — run-dir pattern, ``${now:FMT}`` resolved
      (hydra's ``outputs/<date>/<time>`` default).
    - ``hydra.job_logging`` — when a ``json`` file formatter is configured
      (reference ``conf/hydra_setup.yaml:4-11``), attach a JSON-formatted
      ``<config_name>.log`` file handler in the run dir.
    """
    del version_base

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(argv: tp.Optional[tp.Sequence[str]] = None, **kw):
            args = list(argv if argv is not None else sys.argv[1:])
            overrides = [a for a in args if "=" in a]
            caller_file = Path(sys.modules[fn.__module__].__file__ or ".").parent
            conf_dir = (caller_file / config_path).resolve()
            cfg = compose(conf_dir, config_name, overrides)
            hydra_cfg = to_container(cfg.pop("hydra", {}), resolve=True) if "hydra" in cfg else {}
            job_cfg = hydra_cfg.get("job") or {}
            do_chdir = chdir if chdir is not None else bool(job_cfg.get("chdir", True))
            run_pattern = (hydra_cfg.get("run") or {}).get("dir")
            old_cwd = os.getcwd()
            run_dir = _make_run_dir(Path(old_cwd) / "outputs", pattern=run_pattern)
            hydra_dir = run_dir / ".hydra"
            hydra_dir.mkdir()
            (hydra_dir / "config.yaml").write_text(to_yaml(cfg))
            (hydra_dir / "overrides.yaml").write_text(yaml.safe_dump(overrides))
            log_logger, log_handler = None, None
            fmts = (hydra_cfg.get("job_logging") or {}).get("formatters") or {}
            if "json" in fmts:
                from summer_clip_torch.core.log_utils import setup_json_logging
                log_path = run_dir / f"{config_name}.log"
                log_logger, log_handler = setup_json_logging(log_path)
            if do_chdir:
                os.chdir(run_dir)
            try:
                return fn(cfg, **kw)
            finally:
                if do_chdir:
                    os.chdir(old_cwd)
                if log_handler is not None:
                    log_logger.removeHandler(log_handler)
                    log_handler.close()

        wrapper.__wrapped_config__ = (config_path, config_name)
        return wrapper

    return deco
