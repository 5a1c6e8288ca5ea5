"""Task registry: data-driven task specs + variant derivation.

Replaces the reference's gym-registry-as-task-config
(/root/reference/myosuite/envs/myo/myobase/__init__.py) and its
register_env_variant deep-merge (/root/reference/myosuite/envs/
env_variants.py:113-161). ~200 task variants stay maintainable as data:
an entry is (env class, kwargs); variants clone an entry with a deep-merged
kwargs overlay.

Registering touches no file. A spec's ``model_path`` is either a path or a
callable that materialises the scene and returns its path; it is resolved
in ``make()``, which is also where a missing asset tree is reported.
Families whose ID list itself comes from the asset tree register through
``register_lazy`` and are expanded on first lookup.
"""
from __future__ import annotations

import copy
from typing import Any, Callable

from myosuite_mjx_tpu.models.assets import (  # noqa: F401  (asset: re-export)
    ASSET_ROOT, asset, require_tree)

_REGISTRY: dict[str, tuple[type, dict]] = {}
_PENDING: list[Callable[[], None]] = []


def register(env_id: str, cls: type, kwargs: dict,
             max_episode_steps: int = 100):
  if env_id in _REGISTRY:
    raise ValueError(f"duplicate env id {env_id}")
  kw = dict(kwargs)
  kw.setdefault("horizon", max_episode_steps)
  _REGISTRY[env_id] = (cls, kw)


def register_lazy(fn: Callable[[], None]) -> None:
  """Defer ``fn`` (which calls ``register``) until an ID is first looked
  up, for ID lists that are read from the asset tree."""
  _PENDING.append(fn)


def _spec(env_id: str) -> tuple[type, dict]:
  while env_id not in _REGISTRY and _PENDING:
    _PENDING.pop(0)()
  return _REGISTRY[env_id]


def registry_ids() -> list[str]:
  while _PENDING:
    _PENDING.pop(0)()
  return sorted(_REGISTRY)


def deep_update(base: dict, overlay: dict) -> dict:
  out = copy.deepcopy(base)
  for k, v in overlay.items():
    if isinstance(v, dict) and isinstance(out.get(k), dict):
      out[k] = deep_update(out[k], v)
    else:
      out[k] = copy.deepcopy(v)
  return out


def register_env_variant(env_id: str, variant_id: str, variants: dict,
                         silent: bool = True):
  """Clone a registered env with deep-merged kwarg overrides."""
  cls, kwargs = _spec(env_id)
  register(variant_id, cls, deep_update(kwargs, variants))
  return variant_id


def _resolve(kwargs: dict) -> dict:
  """Materialise a callable ``model_path`` (the scene builders check for
  the asset tree themselves); fail with one message when a path into the
  tree is given and the tree is absent."""
  path = kwargs.get("model_path")
  if callable(path):
    return {**kwargs, "model_path": path()}
  if isinstance(path, str) and path.startswith(ASSET_ROOT):
    require_tree()
  return kwargs


_env_cache: dict[str, Any] = {}


def make(env_id: str, cache: bool = True, **overrides):
  """Instantiate a task env (cached — envs are immutable task objects)."""
  cls, kwargs = _spec(env_id)
  if overrides or not cache:
    return cls(**_resolve(deep_update(kwargs, overrides)))
  if env_id not in _env_cache:
    _env_cache[env_id] = cls(**_resolve(kwargs))
  return _env_cache[env_id]
