"""Visual observation pipeline: rgb keys + pluggable encoders.

Capability parity with the reference's visual-obs plumbing
(/root/reference/myosuite/envs/env_base.py:180-333 encoder setup,
:419-510 get_visuals): visual keys use the same grammar

    'rgb:<cam_name>:<H>x<W>:<encoder>'

with encoders '1d' (flattened uint8), '2d' (HWC uint8), and 'cnn'
(a small JAX convnet producing a fixed-width embedding — the in-repo
stand-in for the reference's torch r3m/rrl/vc1 encoders, which are
downloadable pretrained weights and not reproducible offline).

Split: pixels come from the HOST renderer (rendering is
host-side by design, SURVEY.md §2.2), so visual obs are an *eval/dataset*
surface — `VisualObs.get_visuals(qpos)` — rather than part of the jitted
step. The encoder itself is pure JAX and can embed frames on-device in
batches (``encode(frames)``).
"""
from __future__ import annotations

import numpy as np


def parse_visual_key(key: str):
  """'rgb:cam:HxW:enc' -> (cam, height, width, encoder_id). Mirrors the
  reference's split-from-the-right parsing (env_base.py:450-466) so camera
  names containing ':' survive."""
  if not key.startswith("rgb:"):
    raise ValueError(f"unsupported visual key {key!r}")
  payload = key[4:]
  enc = payload.split(":")[-1]
  payload = payload[: -(len(enc) + 1)]
  wxh = payload.split(":")[-1]
  cam = payload[: -(len(wxh) + 1)]
  h, w = (int(x) for x in wxh.split("x"))
  return cam, h, w, enc


class CNNEncoder:
  """Small convnet embedding [H, W, 3] uint8 -> [out_dim] float32: three
  3x3 stride-2 ReLU convs (16, 32, 32 features) and a dense head."""

  _FEATURES = (16, 32, 32)

  def __init__(self, out_dim: int = 64, seed: int = 0):
    import jax
    self.out_dim = out_dim
    self._params = None
    self._seed = seed
    self._apply = jax.jit(self._forward)

  @staticmethod
  def _forward(params, x):
    import jax
    from myosuite_mjx_tpu.utils import nn
    p = params["params"]
    x = x.astype("float32") / 255.0
    for i in range(len(CNNEncoder._FEATURES)):
      x = jax.nn.relu(nn.conv(p[f"Conv_{i}"], x, strides=(2, 2)))
    x = x.reshape((x.shape[0], -1))
    return nn.dense(p["Dense_0"], x)

  def _ensure(self, sample):
    if self._params is None:
      import jax
      from myosuite_mjx_tpu.utils import nn
      key = jax.random.PRNGKey(self._seed)
      p, cin, (h, w) = {}, sample.shape[-1], sample.shape[1:3]
      for i, feat in enumerate(self._FEATURES):
        p[f"Conv_{i}"] = nn.conv_init(key, f"Conv_{i}", cin, feat)
        cin, h, w = feat, -(-h // 2), -(-w // 2)
      p["Dense_0"] = nn.dense_init(key, "Dense_0", cin * h * w, self.out_dim)
      self._params = {"params": p}

  def __call__(self, frames: np.ndarray) -> np.ndarray:
    """frames [N, H, W, 3] -> [N, out_dim]."""
    import jax.numpy as jnp
    x = jnp.asarray(frames)
    self._ensure(x)
    return np.asarray(self._apply(self._params, x))


_ENCODERS = {
    "1d": lambda frames: np.asarray(frames).reshape(len(frames), -1),
    "2d": lambda frames: np.asarray(frames),
}


def register_encoder(name: str, fn):
  """Plug in a custom encoder callable frames [N,H,W,3] -> features."""
  _ENCODERS[name] = fn


class VisualObs:
  """Host-render + encode visual observations for an env.

  Example:
      vo = VisualObs(env, visual_keys=["rgb:hand_side_inter:84x84:1d"])
      vdict = vo.get_visuals(np.asarray(state.data.qpos))
  """

  def __init__(self, env, visual_keys: list[str]):
    from myosuite_mjx_tpu.utils.render import OffscreenRenderer
    self.env = env
    self.visual_keys = list(visual_keys)
    self._specs = [parse_visual_key(k) for k in self.visual_keys]
    sizes = {(h, w) for _, h, w, _ in self._specs}
    self._renderers = {
        (h, w): OffscreenRenderer(env.model_path, height=h, width=w)
        for (h, w) in sizes}
    self._cnn = None

  def _encode(self, enc: str, frames: np.ndarray) -> np.ndarray:
    if enc in _ENCODERS:
      return _ENCODERS[enc](frames)
    if enc == "cnn":
      if self._cnn is None:
        self._cnn = CNNEncoder()
      return self._cnn(frames)
    raise ValueError(
        f"unknown encoder {enc!r}; available: "
        f"{sorted(_ENCODERS) + ['cnn']}")

  def get_visuals(self, qpos, qvel=None) -> dict:
    """Render + encode every visual key at the given physics state.
    Returns {key: features} (env_base.get_visuals contract)."""
    out = {}
    for key, (cam, h, w, enc) in zip(self.visual_keys, self._specs):
      r = self._renderers[(h, w)]
      r.set_state(np.asarray(qpos),
                  None if qvel is None else np.asarray(qvel))
      cam_id = cam
      try:
        cam_id = int(cam)
      except ValueError:
        pass
      if cam == "" or cam == "free":
        cam_id = -1
      frame = r.render_offscreen(camera_id=cam_id)
      out[key] = self._encode(enc, frame[None])[0]
    return out

  def close(self):
    for r in self._renderers.values():
      r.close()
