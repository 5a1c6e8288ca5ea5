"""Train a task to solve and check the policy into the zoo.

Produces ``train_artifacts/zoo/<env_id>.pkl`` (see train/zoo.py) plus a
small metrics JSON next to it recording the learning curve that produced the
snapshot — the in-repo equivalent of the reference's trained-baselines
release flow (agents/sb3_job_script.py train → save → zoo).

Run: python tools/train_zoo_baseline.py --env myoFingerPoseFixed-v0 \
         [--total-steps 2000000] [--seed 0]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--env", default="myoFingerPoseFixed-v0")
  ap.add_argument("--algo", default="ppo", choices=("ppo", "npg"))
  ap.add_argument("--total-steps", type=int, default=2_000_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--eval-every", type=int, default=50)
  ap.add_argument("--config", default="{}",
                  help="JSON dict of PPOConfig/NPGConfig overrides, e.g. "
                       "'{\"min_log_std\": -1.0, \"num_envs\": 1024}'")
  ap.add_argument("--cpu", action="store_true",
                  help="force CPU JAX (keeps the GPU free)")
  args = ap.parse_args()

  if args.cpu:
    import jax
    jax.config.update("jax_platforms", "cpu")

  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()

  from myosuite_mjx_tpu import envs
  from myosuite_mjx_tpu.train.ppo import PPO, PPOConfig
  from myosuite_mjx_tpu.train import zoo

  env = envs.make(args.env)
  overrides = json.loads(args.config)
  if "hidden" in overrides:
    overrides["hidden"] = tuple(overrides["hidden"])
  if args.algo == "npg":
    from myosuite_mjx_tpu.train.npg import NPG, NPGConfig
    ppo = NPG(env, NPGConfig(**overrides))
  else:
    ppo = PPO(env, PPOConfig(**overrides))

  def progress(it, m):
    if (it + 1) % 10 == 0 or "eval_solved_frac" in m:
      print(json.dumps({"iter": it + 1,
                        **{k: round(float(v), 5) for k, v in m.items()}}),
            flush=True)

  ts, history = ppo.train(total_env_steps=args.total_steps, seed=args.seed,
                          eval_every=args.eval_every, progress=progress)
  evals = [m.get("eval_solved_frac") for m in history
           if "eval_solved_frac" in m]
  succ = [m.get("eval_success") for m in history if "eval_success" in m]
  print(f"final eval_solved_frac: {evals[-1] if evals else None} "
        f"eval_success: {succ[-1] if succ else None}")

  path = os.path.join(zoo.ZOO_DIR, f"{args.env}.pkl")
  if args.algo == "npg":
    zoo.save_npg_snapshot(path, ppo, ts, env_id=args.env)
  else:
    zoo.save_snapshot(path, ppo, ts, env_id=args.env)
  with open(path[:-4] + "_metrics.json", "w") as f:
    json.dump({"env": args.env, "seed": args.seed,
               "total_steps": args.total_steps,
               "history": [{k: float(v) for k, v in m.items()}
                           for m in history]}, f, indent=1)
  print(f"saved zoo baseline to {path}")


if __name__ == "__main__":
  main()
