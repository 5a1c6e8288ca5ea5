"""Visual-obs pipeline: key grammar, host render, encoders end-to-end.

Reference anchor: envs/env_base.py:180-333 (encoders), :419-510
(get_visuals key grammar).
"""
import numpy as np
import pytest

from myosuite_mjx_tpu.envs.visual import (
    CNNEncoder, parse_visual_key, register_encoder)


def test_parse_visual_key_grammar():
  assert parse_visual_key("rgb:hand_side:84x64:2d") == \
      ("hand_side", 84, 64, "2d")
  # camera names containing ':' survive (reference parse quirk)
  assert parse_visual_key("rgb:left:eye:32x32:1d") == \
      ("left:eye", 32, 32, "1d")
  with pytest.raises(ValueError):
    parse_visual_key("depth:cam:8x8:1d")


def test_encoders_shapes():
  frames = np.random.default_rng(0).integers(
      0, 255, (3, 16, 16, 3), dtype=np.uint8)
  from myosuite_mjx_tpu.envs.visual import _ENCODERS
  assert _ENCODERS["1d"](frames).shape == (3, 16 * 16 * 3)
  assert _ENCODERS["2d"](frames).shape == (3, 16, 16, 3)
  enc = CNNEncoder(out_dim=32)
  out = enc(frames)
  assert out.shape == (3, 32)
  assert np.isfinite(out).all()
  # deterministic params
  np.testing.assert_allclose(out, enc(frames))


def test_register_encoder():
  register_encoder("mean_pixel", lambda f: np.asarray(f).mean((1, 2, 3)))
  from myosuite_mjx_tpu.envs.visual import _ENCODERS
  frames = np.ones((2, 4, 4, 3), np.uint8) * 7
  np.testing.assert_allclose(_ENCODERS["mean_pixel"](frames), [7.0, 7.0])


@pytest.mark.slow
def test_get_visuals_end_to_end():
  """Render actual pixels from the finger scene and encode them."""
  from myosuite_mjx_tpu import envs
  from myosuite_mjx_tpu.envs.visual import VisualObs
  import jax
  env = envs.make("myoFingerPoseFixed-v0")
  st = env.reset(jax.random.PRNGKey(0))
  vo = VisualObs(env, ["rgb:free:32x32:1d", "rgb:free:32x32:cnn"])
  vdict = vo.get_visuals(np.asarray(st.data.qpos))
  assert vdict["rgb:free:32x32:1d"].shape == (32 * 32 * 3,)
  assert vdict["rgb:free:32x32:cnn"].shape == (64,)
  # a different pose produces different pixels
  st2 = env.reset(jax.random.PRNGKey(0))
  import jax.numpy as jnp
  st2 = env.step(st2, jnp.full((env.action_dim,), 1.0))
  for _ in range(5):
    st2 = env.step(st2, jnp.full((env.action_dim,), 1.0))
  v2 = vo.get_visuals(np.asarray(st2.data.qpos))
  assert not np.allclose(vdict["rgb:free:32x32:1d"],
                         v2["rgb:free:32x32:1d"])
  vo.close()


@pytest.mark.slow
def test_visual_keys_in_env_obs():
  """visual_keys= on a registered env: rendered features are part of the
  host obs vector (env_base.py:419-510 in-obs visual parity)."""
  from myosuite_mjx_tpu import envs
  import jax
  env = envs.make("myoFingerPoseFixedRGB-v0")
  assert env.visual_keys == [
      "rgb:free:32x32:1d", "rgb:free:32x32:cnn"]
  st = env.reset(jax.random.PRNGKey(0))
  vdict = env.get_visuals(st)
  assert vdict["rgb:free:32x32:1d"].shape == (32 * 32 * 3,)
  assert vdict["rgb:free:32x32:cnn"].shape == (64,)
  full = env.obs_with_visuals(st)
  # proprio prefix is the jitted obs, visual features appended in key order
  n = st.obs.shape[0]
  np.testing.assert_allclose(full[:n], np.asarray(st.obs), rtol=1e-6)
  assert full.shape == (n + 32 * 32 * 3 + 64,)
  # encoder output present and finite (cnn tail)
  assert np.isfinite(full).all()
  assert np.abs(full[n + 32 * 32 * 3:]).sum() > 0
