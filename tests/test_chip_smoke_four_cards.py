"""chip_smoke.py's four-card phase on four of conftest's virtual CPU
devices (its own file, so the test workers run it beside the other
smoke phases)."""
import jax

import chip_smoke
from myosuite_mjx_tpu.train.npg import NPGConfig
from myosuite_mjx_tpu.train.ppo import PPOConfig


def test_four_cards_phase_on_virtual_devices():
  ppo = PPOConfig(num_envs=8, unroll_length=2, num_minibatches=2,
                  update_epochs=1, hidden=(8,), data_groups=4)
  npg = NPGConfig(num_envs=4, hidden=(8,), vf_hidden=(8,), cg_iters=2,
                  vf_batch_size=32)
  out = chip_smoke.phase_four_cards(
      chip_smoke.make_env(horizon=chip_smoke.FOUR_CARD_HORIZON),
      jax.devices("cpu")[:4], ppo, npg)
  assert out["ppo"]["rows_per_card"] == [2, 2, 2, 2]
  assert out["ppo"]["rows_per_card_after"] == [2, 2, 2, 2]
  assert out["npg"]["params_on_cards"] == 4
