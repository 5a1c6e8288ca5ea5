"""Training CLI: the reference's agents-harness entry point, one process.

Capability parity with the reference's training launchers
(/root/reference/myosuite/agents/train_myosuite.sh:1-50 env-list command
generator, sb3_job_script.py:31-131 PPO/SAC job with checkpointing,
hydra_sb3_launcher.py): select env + algorithm + hyperparameters from the
command line, train fully on-device, checkpoint periodically, and resume.

Shape: there are no subprocess vec-envs or per-env cluster
jobs — one jitted train step over a vmapped env batch (optionally sharded
over a device mesh with --mesh), so "one job per env/seed" collapses to a
loop here or one flag per launch.

Usage:
  python -m myosuite_mjx_tpu.train.cli --env myoFingerPoseFixed-v0 \
      --algo ppo --total-steps 1000000 --num-envs 256 \
      --checkpoint-dir /tmp/ckpt --checkpoint-every 50
  python -m myosuite_mjx_tpu.train.cli --env myoHandPose0Fixed-v0 \
      --algo sac --total-steps 200000
  python -m myosuite_mjx_tpu.train.cli --env ... --mesh data  # shard envs
"""
from __future__ import annotations

import argparse
import json
import os
import time

import jax


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--env", required=True, help="registered task ID")
  ap.add_argument("--algo", default="ppo", choices=("ppo", "npg", "sac"))
  ap.add_argument("--total-steps", type=int, default=1_000_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--num-envs", type=int, default=None,
                  help="override the algorithm default")
  ap.add_argument("--learning-rate", type=float, default=None)
  ap.add_argument("--hidden", type=str, default=None,
                  help="comma-separated layer widths, e.g. 256,128")
  ap.add_argument("--mesh", default=None, choices=(None, "data"),
                  help="shard envs over all local devices on a data mesh")
  ap.add_argument("--checkpoint-dir", default=None)
  ap.add_argument("--checkpoint-every", type=int, default=100,
                  help="iterations between checkpoints")
  ap.add_argument("--resume", default=None,
                  help="checkpoint path to resume from")
  ap.add_argument("--log-every", type=int, default=10)
  ap.add_argument("--eval-every", type=int, default=0,
                  help="iterations between deterministic-policy evals "
                       "(ppo only; 0 disables)")
  ap.add_argument("--metrics-out", default=None,
                  help="write the full metrics history as JSON here")
  ap.add_argument("--logdir", default=None,
                  help="per-iteration metrics sink: <logdir>/metrics.jsonl "
                       "+ tensorboard events (sb3_job_script.py:21-45 "
                       "observability parity)")
  return ap


def main(argv=None):
  args = build_parser().parse_args(argv)
  import jax

  # persistent compile cache: the jitted train step dominates cold-start
  # wall time (minutes at hand scale); repeated/resumed runs skip it
  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()

  from myosuite_mjx_tpu import envs
  checkpoint = None
  if args.checkpoint_dir or args.resume:
    from myosuite_mjx_tpu.train import checkpoint

  env = envs.make(args.env)

  overrides = {}
  if args.num_envs is not None:
    overrides["num_envs"] = args.num_envs
  if args.learning_rate is not None:
    overrides["learning_rate"] = args.learning_rate
  if args.hidden is not None:
    overrides["hidden"] = tuple(int(x) for x in args.hidden.split(","))

  if args.algo == "ppo":
    from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig
    cfg = PPOConfig(**overrides)
    learner = PPO(env, cfg)
    per_iter = cfg.unroll_length * cfg.num_envs
  elif args.algo == "npg":
    from myosuite_mjx_tpu.train.npg import NPG, NPGConfig
    cfg = NPGConfig(**overrides)
    learner = NPG(env, cfg)
    per_iter = cfg.num_envs * int(env.horizon)
  else:
    from myosuite_mjx_tpu.train.sac import SAC, SACConfig
    cfg = SACConfig(**overrides)
    learner = SAC(env, cfg)
    per_iter = cfg.num_envs

  if args.mesh == "data":
    from myosuite_mjx_tpu.parallel import mesh as pmesh
    if args.algo != "ppo":
      raise SystemExit("--mesh currently supports --algo ppo")
    learner = pmesh.ShardedPPO(learner, pmesh.data_mesh(jax.devices()))

  ts = learner.init(args.seed)
  start_iter = 0
  if args.resume:
    ts = checkpoint.restore(args.resume, ts)
    # derive completed iterations from the restored env-step counter so the
    # run continues (not restarts): iteration numbering, env_steps, and
    # checkpoint names all pick up where the previous run stopped
    start_iter = int(ts.steps) // per_iter
    print(f"resumed from {args.resume} at iter {start_iter}")

  def _prec(fn):
    # f32 matmuls for learner math too (env step pins its own; GPU f32
    # matmuls default to TF32 — see envs/base.py MyoEnv.step)
    def wrapped(*a):
      with jax.default_matmul_precision("highest"):
        return fn(*a)
    return wrapped

  step_fn = jax.jit(_prec(learner.train_step))
  eval_fn = None
  if args.eval_every and args.algo in ("ppo", "npg"):
    eval_fn = jax.jit(_prec(learner.ppo.eval_step
                            if hasattr(learner, "ppo")
                            else learner.eval_step))
  iters = max(1, args.total_steps // per_iter)
  t0 = time.time()
  last_t, last_steps = t0, start_iter * per_iter
  history = []
  from myosuite_mjx_tpu.train import metrics as metrics_mod
  writer = (metrics_mod.MetricsWriter(
      args.logdir,
      truncate_after=start_iter * per_iter if args.resume else None)
      if args.logdir else None)
  for it in range(start_iter, iters):
    ts, metrics = step_fn(ts)
    if it == start_iter:
      # restart the rate window now that the one-time train-step compile
      # is paid, so the first logged steps_per_s is a real rate
      jax.block_until_ready(ts.params)
      last_t, last_steps = time.time(), (it + 1) * per_iter
    if eval_fn is not None and ((it + 1) % args.eval_every == 0
                                or it == iters - 1):
      metrics = {**metrics, **eval_fn(ts)}
    log_now = (it + 1) % args.log_every == 0 or it == iters - 1
    if log_now or writer is not None:
      metrics = {k: float(v) for k, v in metrics.items()}
      # divergence guard: emergency-checkpoint, then abort loudly
      try:
        metrics_mod.check_finite(metrics, where=f"iter {it + 1}")
      except metrics_mod.DivergenceError:
        if args.checkpoint_dir:
          checkpoint.save(
              os.path.join(args.checkpoint_dir,
                           f"diverged_iter_{it + 1:07d}"), ts)
        raise
      now = time.time()
      steps_now = (it + 1) * per_iter
      # instantaneous rate over the logging window (a cumulative average
      # would stay skewed by the one-time train-step compile for hours)
      rate = (steps_now - last_steps) / max(now - last_t, 1e-9)
      last_t, last_steps = now, steps_now
      rec = {
          "iter": it + 1,
          "env_steps": steps_now,
          "wall_s": round(now - t0, 2),
          "steps_per_s": round(rate, 1),
          **{k: round(v, 5) for k, v in metrics.items()},
      }
      if writer is not None:
        writer.write(rec["env_steps"], rec)
      if log_now:
        history.append(rec)
        print(json.dumps(rec), flush=True)
    if args.checkpoint_dir and ((it + 1) % args.checkpoint_every == 0
                                or it == iters - 1):
      path = os.path.join(args.checkpoint_dir, f"iter_{it + 1:07d}")
      checkpoint.save(path, ts)
  if writer is not None:
    writer.close()
  if args.metrics_out:
    with open(args.metrics_out, "w") as f:
      json.dump({"args": vars(args), "history": history}, f, indent=1)
  return ts


if __name__ == "__main__":
  main()
