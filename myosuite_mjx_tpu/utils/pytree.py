"""Immutable dataclasses that are JAX pytrees.

Every field is a pytree child (array, dict, or nested dataclass), so states
built from these pass through ``jit``, ``vmap``, ``lax.scan`` and sharding
unchanged. Flattening follows field declaration order and key paths are the
field names, so checkpoints keyed by path stay readable across versions.
"""
from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
  """Frozen dataclass + pytree registration + ``replace(**changes)``."""
  cls = dataclasses.dataclass(frozen=True)(cls)
  cls.replace = dataclasses.replace
  jax.tree_util.register_dataclass(
      cls, data_fields=[f.name for f in dataclasses.fields(cls)],
      meta_fields=[])
  return cls
