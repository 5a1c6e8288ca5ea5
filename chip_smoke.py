"""Smoke check of the main path on a GPU: env step, parity, trainers.

Drives what a user runs, on the synthetic hand scene committed in
``myosuite_mjx_tpu/models/synthetic`` (myoHand's widths: 23 hinges, 39
muscles, a free object in the palm; it is not myoHand):

  device  require a GPU, print the card's name and power limit;
  env     jit(vmap(env.autoreset_step)) at B=4096 for 20 control steps;
  parity  one control step of 64 envs on the GPU against the CPU backend,
          and spd_solve at B=4096 against a float64 NumPy solve;
  train   three PPO and two NPG train steps on that env.

Every phase raises on failure; the last line of stdout is one JSON object
naming the device. Run it on one card:

    python chip_smoke.py

``--four-cards`` runs only data-parallel training instead: one ShardedPPO
and one ShardedNPG step on a 4-GPU data mesh, compared with the same step
on one card.

The phase functions take their batch sizes as arguments so the CPU tests
can run them at tiny sizes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.envs import myobase
from myosuite_mjx_tpu.envs.pose import PoseEnv
from myosuite_mjx_tpu.models import synthetic
from myosuite_mjx_tpu.ops import linalg


def card_name_and_power() -> str:
  """``nvidia-smi``'s name and power limit of the first card."""
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def make_env(frame_skip: int = 10, horizon: int = 100) -> PoseEnv:
  """Pose task on the synthetic hand, targets drawn over myoHand's ASL
  pose ranges (the joint names are shared)."""
  return PoseEnv(model_path=synthetic.NPZ_PATH, frame_skip=frame_skip,
                 horizon=horizon, target_jnt_range=myobase._HAND_POSE_RANGES,
                 normalize_act=True, reset_type="init")


def _highest(fn):
  """Jit ``fn`` with f32 matmuls: on the GPU they default to TF32."""
  def wrapped(*a):
    with jax.default_matmul_precision("highest"):
      return fn(*a)
  return jax.jit(wrapped)


def _actions(batch: int, dim: int, seed: int) -> jax.Array:
  return jax.random.uniform(jax.random.PRNGKey(seed), (batch, dim))


def phase_env(env: PoseEnv, batch: int, steps: int = 20) -> dict:
  """Batched autoreset rollout; returns compile seconds and env-steps/s."""
  reset = jax.jit(jax.vmap(env.reset))
  step = jax.jit(jax.vmap(env.autoreset_step), donate_argnums=0)
  st = reset(jax.random.split(jax.random.PRNGKey(0), batch))
  acts = [_actions(batch, env.action_dim, k) for k in range(steps)]
  t0 = time.perf_counter()
  compiled = step.lower(st, acts[0]).compile()
  compile_s = time.perf_counter() - t0
  st = jax.block_until_ready(compiled(st, acts[0]))
  t0 = time.perf_counter()
  for a in acts[1:]:
    st = compiled(st, a)
  st = jax.block_until_ready(st)
  dt = time.perf_counter() - t0
  obs = np.asarray(st.obs)
  want = (batch,) + jax.eval_shape(env.reset, jax.random.PRNGKey(0)).obs.shape
  if obs.shape != want or not np.isfinite(obs).all():
    raise AssertionError(f"env obs not finite or not {want}: {obs.shape}")
  contact = np.asarray(st.data.ne_active) > 0
  if not contact.any():
    raise AssertionError("no env has an active contact after the rollout")
  return {"compile_s": compile_s,
          "env_steps_per_s": batch * (steps - 1) / dt,
          "envs_with_contact": int(contact.sum())}


def phase_parity(env: PoseEnv, batch: int, device, reference) -> dict:
  """One control step on ``device`` and on ``reference`` from the same
  states, f32 under "highest" on both."""
  def run(dev):
    with jax.default_device(dev), jax.default_matmul_precision("highest"):
      st = jax.jit(jax.vmap(env.reset))(
          jax.random.split(jax.random.PRNGKey(1), batch))
      a = _actions(batch, env.action_dim, 99)
      st = jax.jit(jax.vmap(env.step))(st, a)
      return jax.tree.map(np.asarray, (st.data.qpos, st.data.qvel,
                                       st.data.act))
  (qa, va, aa), (qb, vb, ab) = run(device), run(reference)
  out = {"max_dqpos": float(np.abs(qa - qb).max()),
         "max_dact": float(np.abs(aa - ab).max()),
         "max_dqvel_rel": float((np.abs(va - vb) / (1 + np.abs(vb))).max())}
  if not (out["max_dqpos"] <= 1e-4 and out["max_dact"] <= 1e-5
          and out["max_dqvel_rel"] <= 1e-3):
    raise AssertionError(f"device/reference step mismatch: {out}")
  return out


def spd_inputs(batch: int, n: int, seed: int = 0):
  """Mass-matrix-like SPD systems: J^T J plus a diagonal spread over three
  decades (tiny distal inertias next to heavy proximal ones)."""
  rng = np.random.default_rng(seed)
  j = rng.normal(size=(batch, n + 6, n)) * 0.1
  diag = 10.0 ** rng.uniform(-3, 0, size=(batch, n))
  a = np.einsum("bki,bkj->bij", j, j) + diag[:, :, None] * np.eye(n)
  b = rng.normal(size=(batch, n))
  return a, b


def phase_spd(batch: int, sizes=(23, 29)) -> dict:
  """spd_solve in f32 against a float64 NumPy solve; relative residual
  ||a x - b|| / ||b|| of the f32 answer, evaluated in float64."""
  solve = jax.jit(jax.vmap(linalg.spd_solve))
  out = {}
  for n in sizes:
    a, b = spd_inputs(batch, n)
    x = np.asarray(solve(jnp.asarray(a, jnp.float32),
                         jnp.asarray(b, jnp.float32)), np.float64)
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    res = (np.linalg.norm(np.einsum("bij,bj->bi", a, x) - b, axis=-1)
           / np.linalg.norm(b, axis=-1)).max()
    err = (np.linalg.norm(x - ref, axis=-1)
           / np.linalg.norm(ref, axis=-1)).max()
    out[f"n{n}"] = {"max_rel_residual": float(res),
                    "max_rel_error": float(err)}
    if not res <= 1e-4:
      raise AssertionError(f"spd_solve n={n}: relative residual {res}")
  return out


def _finite_loss(metrics: dict, key: str) -> float:
  v = float(metrics[key])
  if not np.isfinite(v):
    raise AssertionError(f"non-finite {key}: {v}")
  return v


def phase_train(env: PoseEnv, ppo_cfg=None, npg_cfg=None,
                ppo_steps: int = 3, npg_steps: int = 2) -> dict:
  """Library entry points: PPO(...).train_step and NPG(...).train_step."""
  from myosuite_mjx_tpu.train.npg import NPG, NPGConfig
  from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig
  out = {}
  for name, learner, n, key in (
      ("ppo", PPO(env, ppo_cfg or PPOConfig(num_envs=1024)), ppo_steps,
       "loss"),
      ("npg", NPG(env, npg_cfg or NPGConfig(num_envs=512)), npg_steps,
       "vf_loss")):
    step = _highest(learner.train_step)
    ts = learner.init(0)
    t0 = time.perf_counter()
    ts, m = step(ts)
    vals = [_finite_loss(m, key)]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n - 1):
      ts, m = step(ts)
      vals.append(_finite_loss(m, key))
    out[name] = {key: vals, "first_step_s": first_s,
                 "later_step_s": (time.perf_counter() - t0) / max(n - 1, 1)}
  return out


def _flat(tree) -> np.ndarray:
  return np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in jax.tree.leaves(tree)])


def _rel(a, b) -> float:
  a, b = _flat(a), _flat(b)
  return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# The four-card comparison holds the sharded step to the one-card step
# within rel 1e-4, so it runs configurations where that is a statement
# about the sharded program and not about chaos: 10-step episodes and one
# optimizer update per PPO step. Over 100-step episodes the muscle
# dynamics amplify last-bit differences between the two programs' kernels
# into visibly different trajectories (rel 1.1e-4 on a 4-device CPU mesh
# with 4 NPG trajectories), and each further Adam update rescales such
# differences by the learning rate.
FOUR_CARD_PPO = dict(num_envs=1024, unroll_length=10, num_minibatches=1,
                     update_epochs=1)
FOUR_CARD_NPG = dict(num_envs=512)
FOUR_CARD_HORIZON = 10


def one_card_steps(env: PoseEnv, device, ppo_cfg, npg_cfg):
  """The PPO and NPG train steps the four-card phase compares with, on one
  card: ((TrainState, metrics), (NPGState, metrics))."""
  from myosuite_mjx_tpu.train.npg import NPG
  from myosuite_mjx_tpu.train.ppo import PPO
  ppo, npg = PPO(env, ppo_cfg), NPG(env, npg_cfg)
  with jax.default_device(device):
    return (_highest(ppo.train_step)(ppo.init(0)),
            _highest(npg.train_step)(npg.init(0)))


def phase_four_cards(env: PoseEnv, devices, ppo_cfg=None,
                     npg_cfg=None) -> dict:
  """One ShardedPPO and one ShardedNPG step on a data mesh over
  ``devices``, each against the same step on ``devices[0]`` alone. Each
  stage prints its seconds as it ends, so a run cut by its time limit
  shows where it was."""
  start = time.perf_counter()

  def stage(name):
    print(f"four_cards: {name} done at {time.perf_counter() - start:.1f} s",
          flush=True)
  from myosuite_mjx_tpu.parallel import mesh as pmesh
  from myosuite_mjx_tpu.train.npg import NPG, NPGConfig
  from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig
  ppo_cfg = ppo_cfg or PPOConfig(**FOUR_CARD_PPO)
  npg_cfg = npg_cfg or NPGConfig(**FOUR_CARD_NPG)
  k = len(devices)
  mesh = pmesh.data_mesh(devices)

  sharded = pmesh.ShardedPPO(PPO(env, ppo_cfg), mesh)
  ts = sharded.init(0)
  rows = {s.device: s.data.shape[0]
          for s in ts.env_state.obs.addressable_shards}
  if set(rows) != set(devices) or set(rows.values()) != {
      ppo_cfg.num_envs // k}:
    raise AssertionError(f"env batch not split over the mesh: {rows}")
  stage("sharded PPO init")
  t0 = time.perf_counter()
  ts_b, m_b = sharded.train_step(ts)
  jax.block_until_ready(ts_b.params)
  ppo_s = time.perf_counter() - t0
  stage("sharded PPO step")
  rows_after = {s.device: s.data.shape[0]
                for s in ts_b.env_state.obs.addressable_shards}

  sh_npg = pmesh.ShardedNPG(NPG(env, npg_cfg), mesh)
  t0 = time.perf_counter()
  tsn_b, mn_b = sh_npg.train_step(sh_npg.init(0))
  jax.block_until_ready(tsn_b.params)
  npg_s = time.perf_counter() - t0
  stage("sharded NPG step")

  (ts_a, m_a), (tsn_a, mn_a) = one_card_steps(env, devices[0], ppo_cfg,
                                              npg_cfg)
  stage("one-card PPO and NPG steps")
  out = {
      "ppo": {"rows_per_card": sorted(rows.values()),
              "rows_per_card_after": sorted(rows_after.values()),
              "param_rel_diff": _rel(ts_b.params, ts_a.params),
              "loss": [float(m_a["loss"]), float(m_b["loss"])],
              "sharded_first_step_s": ppo_s},
      "npg": {"param_rel_diff": _rel(tsn_b.params, tsn_a.params),
              "stoc_pol_mean": [float(mn_a["stoc_pol_mean"]),
                                float(mn_b["stoc_pol_mean"])],
              "params_on_cards": len({s.device for s in jax.tree.leaves(
                  tsn_b.params)[0].addressable_shards}),
              "sharded_first_step_s": npg_s}}
  bad = {n: o["param_rel_diff"] for n, o in out.items()
         if not o["param_rel_diff"] <= 1e-4}
  if bad:
    raise AssertionError(f"sharded step differs from one card: {bad}; "
                         f"{json.dumps(out)}")
  return out


def _log(name: str, result) -> None:
  print(f"{name}: {json.dumps(result)}", flush=True)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--four-cards", action="store_true",
                  help="run only data-parallel PPO/NPG on four cards")
  args = ap.parse_args(argv)

  devices = jax.devices()
  if devices[0].platform != "gpu":
    print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
    return 1
  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()
  card = card_name_and_power()
  print(card, flush=True)

  if args.four_cards:
    if len(devices) < 4:
      print(f"--four-cards needs 4 GPUs, found {len(devices)}",
            file=sys.stderr)
      return 1
    devices = devices[:4]
    _log("four_cards", phase_four_cards(
        make_env(horizon=FOUR_CARD_HORIZON), devices))
  else:
    devices = devices[:1]
    env = make_env()
    env_res = phase_env(env, batch=4096)
    print(f"env: {card}: compile {env_res['compile_s']:.1f} s, "
          f"{env_res['env_steps_per_s']:.1f} env-steps/s at B=4096 "
          f"(synthetic hand, frame_skip 10)", flush=True)
    _log("env", env_res)
    _log("parity_step", phase_parity(env, 64, devices[0],
                                     jax.devices("cpu")[0]))
    _log("parity_spd_solve", phase_spd(4096))
    _log("train", phase_train(env))

  d = jax.devices()[0]
  print(json.dumps({"ok": True, "device": {
      "platform": d.platform, "kind": d.device_kind,
      "count": len(jax.devices())}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
