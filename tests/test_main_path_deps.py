"""The main path needs only JAX, numpy, scipy and optax, and importing the
env suite does no file I/O.

Each check runs in a fresh interpreter with ``mujoco``, ``flax``,
``orbax`` and ``gymnasium`` made unimportable, the way a machine without
them behaves."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = """
import sys
for _name in ("mujoco", "flax", "orbax", "orbax.checkpoint", "gymnasium"):
  sys.modules[_name] = None
import jax
jax.config.update("jax_platforms", "cpu")
"""


def _run(code: str, env_extra: dict | None = None, timeout: int = 600):
  env = {k: v for k, v in os.environ.items()
         if k not in ("JAX_ENABLE_X64", "XLA_FLAGS",
                      "JAX_COMPILATION_CACHE_DIR")}
  env.update({"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
  env.update(env_extra or {})
  proc = subprocess.run(
      [sys.executable, "-c", _BLOCK + textwrap.dedent(code)], env=env,
      capture_output=True, text=True, timeout=timeout, cwd=REPO)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return proc.stdout


def test_env_and_trainers_without_mujoco_flax_orbax():
  out = _run("""
      import jax, jax.numpy as jnp, numpy as np
      import chip_smoke
      from myosuite_mjx_tpu.envs import BatchedEnv
      from myosuite_mjx_tpu.train.npg import NPG, NPGConfig
      from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig
      env = chip_smoke.make_env()
      benv = BatchedEnv(env, 8)
      st = benv.init(0)
      for k in range(2):
        st = benv.step(st, jnp.full((8, env.action_dim), 0.5))
      assert np.isfinite(np.asarray(st.obs)).all()
      ppo = PPO(env, PPOConfig(num_envs=8, unroll_length=2,
                               num_minibatches=2, update_epochs=1,
                               hidden=(8,)))
      _, m = jax.jit(ppo.train_step)(ppo.init(0))
      npg = NPG(env, NPGConfig(num_envs=4, hidden=(8,), vf_hidden=(8,),
                               cg_iters=2))
      _, n = jax.jit(npg.train_step)(npg.init(0))
      assert np.isfinite(float(m["loss"])) and np.isfinite(
          float(n["vf_loss"]))
      print("OK", sorted(k for k in sys.modules
                         if k.split(".")[0] in ("mujoco", "flax", "orbax",
                                                "gymnasium")
                         and sys.modules[k] is not None))
  """)
  assert "OK []" in out


def test_envs_import_writes_nothing_and_make_names_the_variable(tmp_path):
  empty = tmp_path / "assets"
  tmp = tmp_path / "tmp"
  empty.mkdir()
  tmp.mkdir()
  out = _run("""
      import os
      from myosuite_mjx_tpu import envs
      n = len(envs.registry_ids())
      try:
        envs.make("myoHandReorient8-v0")
      except FileNotFoundError as e:
        assert "MYOSUITE_TPU_ASSETS" in str(e), e
        print("OK", n)
  """, env_extra={"MYOSUITE_TPU_ASSETS": str(empty), "TMPDIR": str(tmp),
                  "HOME": str(tmp_path)})
  assert out.startswith("OK ")
  assert int(out.split()[1]) > 200   # every family not read from the tree
  assert list(empty.iterdir()) == [] and list(tmp.iterdir()) == []


@pytest.mark.parametrize("set_var", [True, False])
def test_compile_cache_dir_contract(tmp_path, set_var):
  """With JAX_COMPILATION_CACHE_DIR set the cache is exactly that
  directory; unset, it is the checkout's fixed per-host directory."""
  want = str(tmp_path / "cc")
  out = _run("""
      import jax
      from myosuite_mjx_tpu.utils import compile_cache
      got = compile_cache.enable()
      assert got == jax.config.jax_compilation_cache_dir, got
      print(got)
  """, env_extra={"JAX_COMPILATION_CACHE_DIR": want} if set_var else None)
  got = out.strip().splitlines()[-1]
  if set_var:
    assert got == want
  else:
    head, tag = os.path.split(got)
    assert head == os.path.join(REPO, ".jax_cache")
    assert tag.startswith("host-")
