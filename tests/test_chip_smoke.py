"""chip_smoke.py's phases at tiny sizes on the CPU backend (the card run
uses the same functions at B=4096), and its refusal to run without a GPU."""
import jax
import numpy as np
import pytest

import chip_smoke
from myosuite_mjx_tpu.train.npg import NPGConfig
from myosuite_mjx_tpu.train.ppo import PPOConfig

TINY_PPO = PPOConfig(num_envs=8, unroll_length=2, num_minibatches=2,
                     update_epochs=1, hidden=(8,), data_groups=4)
TINY_NPG = NPGConfig(num_envs=4, hidden=(8,), vf_hidden=(8,), cg_iters=2,
                     vf_batch_size=32)


@pytest.fixture(scope="module")
def env():
  return chip_smoke.make_env()


def test_env_phase(env):
  out = chip_smoke.phase_env(env, batch=4, steps=3)
  assert out["envs_with_contact"] > 0 and out["env_steps_per_s"] > 0


def test_parity_phase_same_backend_is_exact(env):
  cpu = jax.devices("cpu")[0]
  out = chip_smoke.phase_parity(env, 2, cpu, cpu)
  assert out == {"max_dqpos": 0.0, "max_dact": 0.0, "max_dqvel_rel": 0.0}


def test_spd_phase(env):
  out = chip_smoke.phase_spd(9)
  assert set(out) == {"n23", "n29"}
  assert all(v["max_rel_residual"] < 1e-5 for v in out.values())


def test_spd_inputs_are_spd():
  a, _ = chip_smoke.spd_inputs(3, 23)
  np.testing.assert_allclose(a, np.swapaxes(a, 1, 2))
  assert np.linalg.eigvalsh(a).min() > 0


def test_train_phase(env):
  out = chip_smoke.phase_train(env, TINY_PPO, TINY_NPG, 2, 1)
  assert len(out["ppo"]["loss"]) == 2 and len(out["npg"]["vf_loss"]) == 1


def test_main_refuses_cpu(capsys):
  """No GPU: exit code 1 and nothing on stdout, so no result line."""
  assert chip_smoke.main([]) == 1
  assert capsys.readouterr().out == ""
