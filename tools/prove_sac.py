"""SAC graduation run: train finger-pose from scratch and measure success.

Round-4 verdict: SAC has been "experimental" since round 2 with only
mechanics smoke tests — prove it learns at finger scale or drop it. The
reference trains SAC as a first-class algorithm via SB3
(/root/reference/myosuite/agents/sb3_job_script.py:31, selected by
hydra_myo_sb3_sac_config.yaml). This driver trains, runs a deterministic
tanh(mean) eval every checkpoint, and writes the curve to
train_artifacts/sac_proof/<env>.json.

Usage: python tools/prove_sac.py [--env myoFingerPoseFixed-v0] [--cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--env", default="myoFingerPoseFixed-v0")
  ap.add_argument("--total-steps", type=int, default=1_500_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--eval-every-steps", type=int, default=100_000)
  ap.add_argument("--config", default='{"num_envs": 32, '
                  '"updates_per_step": 8, "learning_starts": 5000}')
  ap.add_argument("--cpu", action="store_true")
  args = ap.parse_args()

  if args.cpu:
    import jax
    jax.config.update("jax_platforms", "cpu")

  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()

  import jax
  import jax.numpy as jnp
  from myosuite_mjx_tpu import envs
  from myosuite_mjx_tpu.train.sac import SAC, SACConfig

  env = envs.make(args.env)
  overrides = json.loads(args.config)
  if "hidden" in overrides:
    overrides["hidden"] = tuple(overrides["hidden"])
  sac = SAC(env, SACConfig(**overrides))

  def eval_policy(ts, episodes=32):
    """Deterministic tanh(mean) rollout; reference evaluate_success
    contract (>5 solved steps per episode)."""
    def body(carry, _):
      st, cnt = carry
      mean, _ = sac.actor.apply(ts.actor_params, st.obs)
      nxt = jax.vmap(env.step)(st, jnp.tanh(mean))
      cnt = cnt + nxt.info["solved"].astype(jnp.float32)
      return (nxt, cnt), nxt.info["rwd_dense"]

    st0 = jax.vmap(env.reset)(
        jax.random.split(jax.random.PRNGKey(123), episodes))
    (_, cnt), rews = jax.lax.scan(
        body, (st0, jnp.zeros(episodes)), (), length=env.horizon)
    return dict(eval_success=(cnt > 5).mean(),
                eval_solved_frac=cnt.mean() / env.horizon,
                eval_score=rews.sum(0).mean())

  eval_jit = None
  step_fn = jax.jit(sac.train_step)
  ts = sac.init(args.seed)
  per_iter = sac.cfg.num_envs
  iters = args.total_steps // per_iter
  eval_every = max(1, args.eval_every_steps // per_iter)
  history = []
  t0 = time.time()
  for it in range(iters):
    ts, m = step_fn(ts)
    if (it + 1) % eval_every == 0 or it == iters - 1:
      if eval_jit is None:
        eval_jit = jax.jit(eval_policy)
      ev = {k: float(v) for k, v in eval_jit(ts).items()}
      rec = {"env_steps": (it + 1) * per_iter,
             "wall": round(time.time() - t0, 1),
             **{k: round(float(v), 5) for k, v in m.items()}, **ev}
      history.append(rec)
      print(json.dumps(rec), flush=True)

  out_dir = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "train_artifacts", "sac_proof")
  os.makedirs(out_dir, exist_ok=True)
  out = os.path.join(out_dir, f"{args.env}.json")
  with open(out, "w") as f:
    json.dump({"env": args.env, "seed": args.seed,
               "config": overrides, "history": history}, f, indent=1)
  best = max((h["eval_success"] for h in history), default=0.0)
  print(f"saved {out}; best eval_success={best}")


if __name__ == "__main__":
  main()
