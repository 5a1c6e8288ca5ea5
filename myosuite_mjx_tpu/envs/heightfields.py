"""Procedural terrain generators (device-side) + local heightmap obs.

Capability parity with the reference HeightField stack
(/root/reference/myosuite/envs/heightfields.py:78-453): ChaseTag-style
quadrant fields (FLAT / HILLY / ROUGH / RELIEF) and Track-style per-segment
difficulty schedules, plus the raycast-free local heightmap observation.
Redesigned for batching: generation is pure JAX of a PRNG key, producing an
``hfield_data`` overlay consumed by the collision stage — terrain
randomizes per episode entirely on device (the reference writes
sim.model.hfield_data on the host each reset).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def flat(shape, dtype=jnp.float32):
  return jnp.zeros(shape, dtype)


def rough(rng, shape, amplitude=1.0, dtype=jnp.float32):
  """White-noise rubble."""
  return amplitude * jax.random.uniform(rng, shape, dtype)


def hilly(rng, shape, periods=3.0, amplitude=1.0, dtype=jnp.float32):
  """Smooth random hills (sum of low-frequency sinusoids)."""
  nrow, ncol = shape
  k1, k2, k3 = jax.random.split(rng, 3)
  y = jnp.linspace(0, 2 * jnp.pi * periods, nrow)[:, None]
  x = jnp.linspace(0, 2 * jnp.pi * periods, ncol)[None, :]
  p1 = jax.random.uniform(k1, (), dtype, 0, 2 * jnp.pi)
  p2 = jax.random.uniform(k2, (), dtype, 0, 2 * jnp.pi)
  w = jax.random.uniform(k3, (2,), dtype, 0.5, 1.5)
  h = (jnp.sin(w[0] * x + p1) * jnp.cos(w[1] * y + p2) + 1.0) * 0.5
  return (amplitude * h).astype(dtype)


def relief(rng, shape, n_bumps=8, amplitude=1.0, dtype=jnp.float32):
  """Isolated gaussian bumps."""
  nrow, ncol = shape
  k1, k2, k3 = jax.random.split(rng, 3)
  cy = jax.random.uniform(k1, (n_bumps,), dtype, 0, nrow)
  cx = jax.random.uniform(k2, (n_bumps,), dtype, 0, ncol)
  sig = jax.random.uniform(k3, (n_bumps,), dtype, 1.0, float(min(shape)) / 6)
  yy = jnp.arange(nrow, dtype=dtype)[:, None, None]
  xx = jnp.arange(ncol, dtype=dtype)[None, :, None]
  bumps = jnp.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                    / (2 * sig ** 2)))
  return (amplitude * jnp.clip(bumps.sum(-1), 0, 1)).astype(dtype)


def stairs(rng, shape, n_steps=8, amplitude=1.0, dtype=jnp.float32):
  """Staircase along the row axis with random step heights."""
  nrow, ncol = shape
  heights = jnp.cumsum(
      jax.random.uniform(rng, (n_steps,), dtype, 0.3, 1.0))
  heights = heights / heights[-1]
  idx = jnp.clip((jnp.arange(nrow) * n_steps) // nrow, 0, n_steps - 1)
  return (amplitude * jnp.broadcast_to(
      heights[idx][:, None], shape)).astype(dtype)


class ChaseTagField:
  """Quadrant terrain: each quadrant drawn FLAT/HILLY/ROUGH/RELIEF
  (reference ChaseTagField, heightfields.py:187-320)."""

  def __init__(self, nrow: int, ncol: int,
               rough_amplitude=0.15, hills_amplitude=0.3,
               relief_amplitude=0.4):
    self.shape = (nrow, ncol)
    self.amps = (rough_amplitude, hills_amplitude, relief_amplitude)

  def generate(self, rng: jax.Array) -> jax.Array:
    nrow, ncol = self.shape
    hr, hc = nrow // 2, ncol // 2
    qshape = (hr, hc)
    keys = jax.random.split(rng, 8)
    quads = []
    for i in range(4):
      k_type, k_gen = keys[2 * i], keys[2 * i + 1]
      variants = jnp.stack([
          flat(qshape),
          hilly(k_gen, qshape, amplitude=self.amps[1]),
          rough(k_gen, qshape, amplitude=self.amps[0]),
          relief(k_gen, qshape, amplitude=self.amps[2]),
      ])
      pick = jax.random.randint(k_type, (), 0, 4)
      quads.append(variants[pick])
    top = jnp.concatenate([quads[0], quads[1]], axis=1)
    bot = jnp.concatenate([quads[2], quads[3]], axis=1)
    field = jnp.concatenate([top, bot], axis=0)
    # pad to full shape if odd dims
    out = jnp.zeros(self.shape, field.dtype)
    return out.at[:2 * hr, :2 * hc].set(field).ravel()


class TrackField:
  """Per-segment difficulty track: rough / hilly / stairs sections
  (reference TrackField, heightfields.py:322-453)."""

  def __init__(self, nrow: int, ncol: int, n_segments: int = 4):
    self.shape = (nrow, ncol)
    self.n_segments = n_segments

  def generate(self, rng: jax.Array, difficulty: float = 1.0) -> jax.Array:
    nrow, ncol = self.shape
    seg_rows = nrow // self.n_segments
    keys = jax.random.split(rng, 2 * self.n_segments)
    segs = []
    for i in range(self.n_segments):
      k_type, k_gen = keys[2 * i], keys[2 * i + 1]
      amp = difficulty * (i + 1) / self.n_segments
      sshape = (seg_rows, ncol)
      variants = jnp.stack([
          rough(k_gen, sshape, amplitude=0.3 * amp),
          hilly(k_gen, sshape, amplitude=0.6 * amp),
          stairs(k_gen, sshape, amplitude=amp),
      ])
      pick = jax.random.randint(k_type, (), 0, 3)
      segs.append(variants[pick])
    field = jnp.concatenate(segs, axis=0)
    out = jnp.zeros(self.shape, field.dtype)
    return out.at[:field.shape[0]].set(field).ravel()


class ChallengeTrackField:
  """MyoChallenge-2024 run-track terrain (reference TrackField,
  heightfields.py:322-453), generated device-side per episode.

  Faithful patch recipes: stairs = 3 ascending + 3 descending flats of the
  per-patch difficulty height; hilly = one smooth sine bump normalized over
  the patch; rough = uniform noise scaled by U(0, difficulty). Difficulty
  schedules are reversed at construction because hfield row indexing runs
  against the walking direction (heightfields.py:340-342). reset modes:
  'flat', 'random' (one terrain type per episode), 'random_mixed' (random
  type per patch). Terrain-type codes follow run_track_v0.py:24-30.
  """

  FLAT, HILLY, ROUGH, STAIRS, MIXED = 0, 1, 2, 3, 4

  def __init__(self, nrow: int, ncol: int, rough_difficulties,
               hills_difficulties, stairs_difficulties,
               reset_type: str = "random"):
    self.shape = (nrow, ncol)
    self.rough_d = np.asarray(rough_difficulties[::-1], np.float64)
    self.hills_d = np.asarray(hills_difficulties[::-1], np.float64)
    self.stairs_d = np.asarray(stairs_difficulties[::-1], np.float64)
    self.reset_type = reset_type

  def _patch_bounds(self, n_patches: int):
    nrow = self.shape[0]
    starts = np.arange(0, nrow, nrow // n_patches)
    return [(int(starts[i]), int(starts[i + 1]))
            for i in range(len(starts) - 1)]

  def _stairs_patch(self, lo, hi, h, dtype):
    length = hi - lo
    flat_len = length // 6
    heights = jnp.concatenate([
        jnp.full((flat_len,), lvl, dtype)
        for lvl in (0.0, 1.0, 2.0, 3.0, 2.0, 1.0)])
    heights = jnp.concatenate(
        [heights, jnp.zeros((length - 6 * flat_len,), dtype)]) * h
    return jnp.broadcast_to(heights[:, None], (length, self.shape[1]))

  def _hilly_patch(self, lo, hi, scalar, dtype):
    length = hi - lo
    ncol = self.shape[1]
    data = jnp.sin(jnp.linspace(0.0, jnp.pi, length * ncol, dtype=dtype))
    data = (data - data.min()) / jnp.maximum(data.max() - data.min(), 1e-12)
    return jnp.flip(data.reshape(length, ncol) * scalar, (0, 1))

  def _rough_patch(self, rng, lo, hi, difficulty, dtype):
    length = hi - lo
    k1, k2 = jax.random.split(rng)
    fill = jax.random.uniform(k1, (length, self.shape[1]), dtype, -1.0, 1.0)
    fill = (fill - fill.min()) / jnp.maximum(fill.max() - fill.min(), 1e-12)
    return fill * jax.random.uniform(k2, (), dtype, 0.0, difficulty)

  def generate(self, rng: jax.Array, dtype=jnp.float32):
    """(hfield_data overlay [nrow*ncol], terrain_type code)."""
    nrow, ncol = self.shape
    if self.reset_type == "flat":
      return jnp.zeros((nrow * ncol,), dtype), jnp.asarray(self.FLAT,
                                                           jnp.int32)
    k_type, k_gen = jax.random.split(rng)
    # per-patch fields for each of the three terrain programs
    def full_field(kind: int, key) -> jax.Array:
      d = (self.stairs_d, self.hills_d, self.rough_d)[kind]
      out = jnp.zeros((nrow, ncol), dtype)
      for i, (lo, hi) in enumerate(self._patch_bounds(len(d))):
        key_i = jax.random.fold_in(key, i)
        if kind == 0:
          patch = self._stairs_patch(lo, hi, float(d[i]), dtype)
        elif kind == 1:
          patch = self._hilly_patch(lo, hi, float(d[i]), dtype)
        else:
          patch = self._rough_patch(key_i, lo, hi, float(d[i]), dtype)
        out = out.at[lo:hi].set(patch)
      return out

    fields = jnp.stack([full_field(k, jax.random.fold_in(k_gen, k))
                        for k in range(3)])
    if self.reset_type == "random_mixed":
      # random type per patch: blend the three full fields by patch mask
      d = self.stairs_d
      n = len(self._patch_bounds(len(d)))
      picks = jax.random.randint(k_type, (n,), 0, 3)
      out = jnp.zeros((nrow, ncol), dtype)
      for i, (lo, hi) in enumerate(self._patch_bounds(len(d))):
        out = out.at[lo:hi].set(fields[picks[i], lo:hi])
      return out.ravel(), jnp.asarray(self.MIXED, jnp.int32)
    pick = jax.random.randint(k_type, (), 0, 3)
    type_code = jnp.asarray(
        [self.STAIRS, self.HILLY, self.ROUGH], jnp.int32)[pick]
    return fields[pick].ravel(), type_code


def local_heightmap(hfield_data: jax.Array, nrow: int, ncol: int,
                    size_xy, xy: jax.Array, patch=(10, 10)) -> jax.Array:
  """Grid heightmap around world position ``xy`` (raycast-free lookup,
  reference HeightField.get_heightmap semantics, heightfields.py:102-174)."""
  data = hfield_data.reshape(nrow, ncol)
  sx, sy = size_xy
  gx = (xy[0] + sx) / (2 * sx) * (ncol - 1)
  gy = (xy[1] + sy) / (2 * sy) * (nrow - 1)
  pr, pc = patch
  rows = jnp.clip(jnp.arange(pr) - pr // 2 + gy.astype(jnp.int32),
                  0, nrow - 1)
  cols = jnp.clip(jnp.arange(pc) - pc // 2 + gx.astype(jnp.int32),
                  0, ncol - 1)
  return data[rows[:, None], cols[None, :]]
