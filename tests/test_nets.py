"""The plain-JAX policy, value and encoder nets against flax.linen modules
written the way the trainers used to define them: same parameter tree,
same initial weights at a seed, same outputs on the same parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn

from myosuite_mjx_tpu.envs.visual import CNNEncoder
from myosuite_mjx_tpu.train import npg, ppo, sac


class FlaxActorCritic(fnn.Module):
  act_dim: int
  hidden: tuple
  init_log_std: float = -0.5
  min_log_std: float = -jnp.inf

  @fnn.compact
  def __call__(self, obs):
    x = obs
    for h in self.hidden:
      x = fnn.tanh(fnn.Dense(h)(x))
    mean = fnn.Dense(self.act_dim)(x)
    log_std = self.param("log_std", fnn.initializers.constant(
        self.init_log_std), (self.act_dim,))
    log_std = jnp.maximum(log_std, self.min_log_std)
    v = obs
    for h in self.hidden:
      v = fnn.tanh(fnn.Dense(h)(v))
    return mean, log_std, fnn.Dense(1)(v)[..., 0]


class FlaxGaussianMLP(fnn.Module):
  act_dim: int
  hidden: tuple
  init_log_std: float = -0.25
  min_log_std: float = -1.0

  @fnn.compact
  def __call__(self, obs):
    x = obs
    for h in self.hidden:
      x = fnn.tanh(fnn.Dense(h)(x))
    mean = fnn.Dense(self.act_dim)(x)
    log_std = self.param("log_std", fnn.initializers.constant(
        self.init_log_std), (self.act_dim,))
    return mean, jnp.maximum(log_std, self.min_log_std)


class FlaxValueMLP(fnn.Module):
  hidden: tuple

  @fnn.compact
  def __call__(self, obs, tfrac):
    t = jnp.stack([tfrac, tfrac ** 2, tfrac ** 3], axis=-1)
    x = jnp.concatenate([obs, t], axis=-1)
    for h in self.hidden:
      x = fnn.relu(fnn.Dense(h)(x))
    return fnn.Dense(1)(x)[..., 0]


class FlaxActor(fnn.Module):
  act_dim: int
  hidden: tuple

  @fnn.compact
  def __call__(self, obs):
    x = obs
    for h in self.hidden:
      x = fnn.relu(fnn.Dense(h)(x))
    return (fnn.Dense(self.act_dim)(x),
            jnp.clip(fnn.Dense(self.act_dim)(x), -20.0, 2.0))


class FlaxTwinQ(fnn.Module):
  hidden: tuple

  @fnn.compact
  def __call__(self, obs, act):
    def q(x):
      for h in self.hidden:
        x = fnn.relu(fnn.Dense(h)(x))
      return fnn.Dense(1)(x)[..., 0]
    xin = jnp.concatenate([obs, act], axis=-1)
    return q(xin), q(xin)


class FlaxCNN(fnn.Module):
  @fnn.compact
  def __call__(self, x):
    x = x.astype("float32") / 255.0
    for feat in (16, 32, 32):
      x = fnn.relu(fnn.Conv(feat, (3, 3), strides=(2, 2))(x))
    return fnn.Dense(64)(x.reshape((x.shape[0], -1)))


OBS, ACT = 11, 4
_o = jax.random.normal(jax.random.PRNGKey(5), (6, OBS))
_a = jax.random.normal(jax.random.PRNGKey(6), (6, ACT))
_t = jnp.linspace(0.0, 1.0, 6)

CASES = {
    "ppo_actor_critic": (ppo.ActorCritic(ACT, (16, 8)),
                         FlaxActorCritic(ACT, (16, 8)), (_o,)),
    "ppo_min_log_std": (ppo.ActorCritic(ACT, (8,), -2.0, -1.0),
                        FlaxActorCritic(ACT, (8,), -2.0, -1.0), (_o,)),
    "npg_policy": (npg.GaussianMLP(ACT, (8, 8)),
                   FlaxGaussianMLP(ACT, (8, 8)), (_o,)),
    "npg_value": (npg.ValueMLP((16, 16)), FlaxValueMLP((16, 16)),
                  (_o, _t)),
    "sac_actor": (sac.Actor(ACT, (16, 16)), FlaxActor(ACT, (16, 16)),
                  (_o,)),
    "sac_twin_q": (sac.TwinQ((16, 16)), FlaxTwinQ((16, 16)), (_o, _a)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_init_as_flax(name):
  ours, ref, args = CASES[name]
  key = jax.random.PRNGKey(3)
  p_ours = ours.init(key, *[x[0] for x in args])
  p_ref = ref.init(key, *[x[0] for x in args])
  assert (jax.tree.structure(p_ours) == jax.tree.structure(p_ref))
  for a, b in zip(jax.tree.leaves(p_ours), jax.tree.leaves(p_ref)):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outputs_as_flax_on_shared_params(name):
  ours, ref, args = CASES[name]
  params = ref.init(jax.random.PRNGKey(9), *[x[0] for x in args])
  # perturb every leaf so zero biases and constant log-stds are exercised
  leaves, tree = jax.tree.flatten(params)
  keys = jax.random.split(jax.random.PRNGKey(10), len(leaves))
  params = jax.tree.unflatten(tree, [
      x + 0.3 * jax.random.normal(k, x.shape, x.dtype)
      for x, k in zip(leaves, keys)])
  for a, b in zip(jax.tree.leaves(ours.apply(params, *args)),
                  jax.tree.leaves(ref.apply(params, *args))):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-6, atol=1e-6)


def test_cnn_encoder_matches_flax():
  frames = np.random.default_rng(0).integers(
      0, 255, (2, 32, 30, 3)).astype(np.uint8)
  enc = CNNEncoder(out_dim=64, seed=0)
  out = enc(frames)
  ref = FlaxCNN()
  p_ref = ref.init(jax.random.PRNGKey(0), jnp.asarray(frames))
  for a, b in zip(jax.tree.leaves(enc._params), jax.tree.leaves(p_ref)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  np.testing.assert_allclose(out, np.asarray(ref.apply(p_ref, frames)),
                             rtol=1e-5, atol=1e-5)


def test_zoo_ppo_snapshot_acts_as_under_flax():
  """A committed zoo policy (PPO ActorCritic params) gives the actions the
  flax module gives on the same parameters."""
  from myosuite_mjx_tpu.train import zoo
  pol = zoo.load_baseline("myoElbowPose1D6MRandom-v0")
  snap = pol.snap
  assert "params" in snap
  ref = FlaxActorCritic(snap["act_dim"], tuple(snap["hidden"]))
  obs_dim = snap["params"]["params"]["Dense_0"]["kernel"].shape[0]
  obs = jax.random.normal(jax.random.PRNGKey(0), (16, obs_dim))
  params = jax.tree.map(jnp.asarray, snap["params"])
  x = obs
  if snap.get("normalize_obs", False):
    x = jnp.clip((obs - snap["obs_mean"]) / jnp.sqrt(snap["obs_var"] + 1e-8),
                 -snap.get("norm_clip", 10.0), snap.get("norm_clip", 10.0))
  want = jnp.clip(ref.apply(params, x)[0], -1.0, 1.0)
  np.testing.assert_allclose(np.asarray(pol.act(obs)), np.asarray(want),
                             rtol=1e-6, atol=1e-6)
