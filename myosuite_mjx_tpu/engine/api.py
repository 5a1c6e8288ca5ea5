"""Public engine API: per-model compiled physics handles.

``Physics`` closes jitted step/forward functions over an immutable Model, so
model constants fold into the XLA program — the batched replacement for
the reference's SimScene handle (/root/reference/myosuite/physics/
sim_scene.py:38-209). Batched simulation is ``vmap`` over Data.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from myosuite_mjx_tpu.engine import data as data_mod
from myosuite_mjx_tpu.engine import forward as forward_mod
from myosuite_mjx_tpu.engine import model as model_mod
from myosuite_mjx_tpu.engine.data import Data
from myosuite_mjx_tpu.engine.model import Model


class Physics:
  """Compiled physics for one model.

  step/forward are jitted single-env functions; step_batch/forward_batch are
  their vmapped twins (leading batch axis over every Data leaf).
  """

  def __init__(self, m: Model, dtype=jnp.float32):
    self.model = m
    self.dtype = dtype

    def _prec(fn):
      # float32 physics needs true-f32 matmuls; the GPU default (TF32)
      # keeps ~3 decimal digits, too few for the wrap/cholesky math.
      def wrapped(*args, **kw):
        with jax.default_matmul_precision("highest"):
          return fn(*args, **kw)
      return wrapped

    self.step = jax.jit(_prec(functools.partial(forward_mod.step, m)))
    self.forward = jax.jit(_prec(functools.partial(forward_mod.forward, m)))
    self.step_batch = jax.jit(
        _prec(jax.vmap(functools.partial(forward_mod.step, m))))
    self.forward_batch = jax.jit(
        _prec(jax.vmap(functools.partial(forward_mod.forward, m))))

    def _substep(d: Data, n: int) -> Data:
      def body(d, _):
        return forward_mod.step(m, d), ()
      with jax.default_matmul_precision("highest"):
        d, _ = jax.lax.scan(body, d, (), length=n)
      return d

    self._substep = _substep

  def make_data(self) -> Data:
    return data_mod.make_data(self.model, dtype=self.dtype)

  @functools.lru_cache(maxsize=None)
  def step_n(self, n: int):
    """Jitted n-substep advance (the Robot frame_skip loop, fused)."""
    return jax.jit(functools.partial(self._substep, n=n))


@functools.lru_cache(maxsize=64)
def _cached_physics(path: str, dtype_name: str) -> Physics:
  m = model_mod.load_model(path)
  return Physics(m, dtype=jnp.dtype(dtype_name).type)


def load(path: str, dtype=jnp.float32) -> Physics:
  """Compile an MJCF file into a cached Physics handle."""
  return _cached_physics(path, jnp.dtype(dtype).name)
