"""Scaling-efficiency meter on a virtual device mesh.

Multi-chip hardware is unavailable in this sandbox, so this measures what
CAN be measured without it (SURVEY.md §2.4 scaling evidence):

  * numeric parity — the sharded PPO train step produces the same params
    and metrics as the single-device program at every mesh size n (the
    data-parallel program is the same math; XLA only changes placement),
  * program scaling — per-iteration env-step throughput at n = 1,2,4,8
    virtual devices, confirming the sharded step executes and its cost
    does not blow up with mesh size.

CAVEAT (printed in the report): the n "devices" are XLA host-platform
slices of ONE CPU, sharing cores and memory bandwidth — absolute steps/s
and the per-device scaling curve are NOT hardware scaling numbers. On a
real multi-GPU machine the same program's collectives ride NVLink; this tool is the
correctness + compilation half of that evidence.

Run:  python tools/scaling_efficiency.py [--num-envs 64] [--iters 5]
Writes docs/scaling_efficiency.md with the measured table.
"""
import argparse
import os
import sys
import time

# hard-force CPU: this tool measures the virtual CPU mesh
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402


def run(num_envs: int, iters: int, env_id: str):
  from myosuite_mjx_tpu import envs
  from myosuite_mjx_tpu.parallel import mesh as pmesh
  from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig

  env = envs.make(env_id)
  cfg = PPOConfig(num_envs=num_envs, unroll_length=8, num_minibatches=4,
                  update_epochs=2, data_groups=8)
  ppo = PPO(env, cfg)
  per_iter = cfg.num_envs * cfg.unroll_length
  # parity config: ONE optimizer update per train_step. With several Adam
  # updates per step, f32 reduction-order noise (different shardings sum
  # gradients in a different order) gets amplified by ~lr per update and
  # params drift O(1e-3) while the math is still the same program — so the
  # tight numeric check runs on a single-update config and the timing on
  # the full config.
  pcfg = PPOConfig(num_envs=num_envs, unroll_length=8, num_minibatches=1,
                   update_epochs=1, data_groups=8)
  pppo = PPO(env, pcfg)

  ts_ref, m_ref = jax.jit(pppo.train_step)(pppo.init(0))

  rows = []
  for n in (1, 2, 4, 8):
    devs = jax.devices()[:n]
    psh = pmesh.ShardedPPO(pppo, pmesh.data_mesh(devs))
    ts_p, m_p = psh.train_step(psh.init(0))
    # full-pytree parity: every layer's weights and the policy log_std.
    # atol rationale: cross-device psum reduction ORDER differs from the
    # single-device sum, giving ~1e-7 gradient noise; Adam normalizes
    # near-zero gradients, amplifying that noise to learning-rate scale
    # (3e-4) on a fraction of elements after the update. 2e-3 bounds the
    # update to the same optimizer step while catching real sharding bugs
    # (wrong shard sums are O(1) off).
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-3,
            err_msg=f"sharded(n={n}) != single-device params"),
        ts_p.params, ts_ref.params)
    np.testing.assert_allclose(
        float(m_p["reward_mean"]), float(m_ref["reward_mean"]), rtol=1e-3)

    sharded = pmesh.ShardedPPO(ppo, pmesh.data_mesh(devs))
    ts, m = sharded.train_step(sharded.init(0))  # compile
    t0 = time.time()
    for _ in range(iters):
      ts, m = sharded.train_step(ts)
    jax.block_until_ready(ts.params)
    dt = time.time() - t0
    sps = per_iter * iters / dt
    rows.append((n, sps, sps / n))
    print(f"n={n}: parity ok, {sps:,.0f} env-steps/s "
          f"({sps / n:,.0f}/device)", flush=True)
  return rows, env_id, num_envs


def write_doc(rows, env_id, num_envs, path):
  lines = [
      "# Scaling efficiency on the virtual device mesh",
      "",
      f"`python tools/scaling_efficiency.py` — PPO train step on {env_id},",
      f"{num_envs} envs, sharded over n virtual CPU devices "
      "(`--xla_force_host_platform_device_count=8`).",
      "",
      "At every n the sharded step's params match the single-device",
      "program to 2e-3 / metrics to 1e-3 on a one-optimizer-update",
      "config (asserted before timing; the residual is f32 psum",
      "reduction-order noise amplified to lr scale by Adam on near-zero",
      "gradients — wrong shard sums would be O(1) off): the data-parallel",
      "rewrite is placement-only, so correctness transfers to real",
      "meshes where the same collectives ride NVLink.",
      "",
      "**Caveat:** the n \"devices\" are slices of one CPU sharing cores",
      "and bandwidth — absolute steps/s here measure program overhead,",
      "not hardware scaling. Real multi-chip cannot run in this sandbox.",
      "",
      "| n devices | env-steps/s | env-steps/s/device | parity |",
      "|---|---|---|---|",
  ]
  for n, sps, spd in rows:
    lines.append(f"| {n} | {sps:,.0f} | {spd:,.0f} | ok (2e-3) |")
  with open(path, "w") as f:
    f.write("\n".join(lines) + "\n")
  print(f"wrote {path}")


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--num-envs", type=int, default=64)
  ap.add_argument("--iters", type=int, default=5)
  ap.add_argument("--env", default="myoFingerPoseRandom-v0")
  ap.add_argument("--out", default=os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      "docs", "scaling_efficiency.md"))
  args = ap.parse_args()
  rows, env_id, ne = run(args.num_envs, args.iters, args.env)
  write_doc(rows, env_id, ne, args.out)


if __name__ == "__main__":
  main()
