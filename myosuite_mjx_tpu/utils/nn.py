"""Plain-JAX dense and conv layers for the policy, value and encoder nets.

Parameters use flax.linen's tree layout (``{"Dense_0": {"kernel", "bias"},
...}``) and its initialisation (LeCun-normal kernels, zero biases, each
layer's key folded from the init key and the layer name exactly as linen
does). Policies pickled in ``train_artifacts/`` and checkpoints of earlier
runs therefore load unchanged, and a fresh init at a given seed reproduces
the same weights.
"""
from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp

_kernel_init = jax.nn.initializers.lecun_normal()


def layer_key(key: jax.Array, name: str) -> jax.Array:
  """The key linen hands a layer's first parameter: the init key folded
  with the SHA-1 of (layer name, 1)."""
  h = hashlib.sha1(name.encode() + b"\x01").digest()
  return jax.random.fold_in(key, jnp.uint32(int.from_bytes(h[:4], "big")))


def dense_init(key: jax.Array, name: str, din: int, dout: int) -> dict:
  return {"kernel": _kernel_init(layer_key(key, name), (din, dout),
                                 jnp.float32),
          "bias": jnp.zeros((dout,), jnp.float32)}


def dense(p: dict, x: jax.Array) -> jax.Array:
  return x @ p["kernel"] + p["bias"]


def mlp_init(key: jax.Array, sizes, first: int = 0) -> dict:
  """Layers ``Dense_{first}`` ... mapping sizes[0] -> ... -> sizes[-1]."""
  return {f"Dense_{first + i}": dense_init(key, f"Dense_{first + i}", a, b)
          for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


def mlp(p: dict, x: jax.Array, n: int, act, first: int = 0) -> jax.Array:
  """Apply ``n`` dense layers from ``Dense_{first}``; ``act`` between
  layers, none after the last."""
  for i in range(n):
    x = dense(p[f"Dense_{first + i}"], x)
    if i < n - 1:
      x = act(x)
  return x


def conv_init(key: jax.Array, name: str, cin: int, cout: int,
              ksize=(3, 3)) -> dict:
  return {"kernel": _kernel_init(layer_key(key, name),
                                 (*ksize, cin, cout), jnp.float32),
          "bias": jnp.zeros((cout,), jnp.float32)}


def conv(p: dict, x: jax.Array, strides=(1, 1)) -> jax.Array:
  """NHWC convolution with SAME padding (linen ``nn.Conv`` defaults)."""
  y = jax.lax.conv_general_dilated(
      x, p["kernel"], strides, "SAME",
      dimension_numbers=("NHWC", "HWIO", "NHWC"))
  return y + p["bias"]
