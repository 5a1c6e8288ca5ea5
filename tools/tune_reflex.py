"""Population gain-tuning for the reflex walking controller (myoLeg).

This is the batched use case the reflex port was built for (agents/reflex.py
docstring): the reference ships a gain set tuned for a 2022 myoLeg
(agents/baseline_Reflex tutorial baseline_params.txt) that collapses on
the current myolegs.xml — reproducibly with the reference's own
controller.  Here we re-tune the 46 Song & Geyer gains against the
shipped model by vmapping whole 10 s rollouts over a population on one
chip and running CEM on the host.

Fitness (classic reflex-gait objective): distance walked before falling
plus survival time; falling = pelvis leaves the [0.65, 1.25] m band or
pitches/rolls past 60 deg.

Usage:
  python tools/tune_reflex.py --generations 40 --pop 256 \
      --out train_artifacts/reflex_gains.npz
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--generations", type=int, default=40)
  ap.add_argument("--pop", type=int, default=256)
  ap.add_argument("--elite", type=int, default=32)
  ap.add_argument("--ticks", type=int, default=1000,
                  help="control ticks per rollout (10 ms each)")
  ap.add_argument("--sigma", type=float, default=0.15)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--out", default="train_artifacts/reflex_gains.npz")
  ap.add_argument("--init", default=None,
                  help="npz with a 'params' array to warm-start from")
  args = ap.parse_args()

  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()
  import jax
  import jax.numpy as jnp
  from myosuite_mjx_tpu.agents import reflex

  walker = reflex.ReflexWalker()
  d0, s0 = walker.reset()
  pelvis = walker.pelvis_bid
  # upright reference: the myolegs pelvis BODY frame is rotated (its local
  # z is horizontal at stance — xmat[2,2] ~= 0 standing), so "upright" is
  # measured against the body axis that points world-up at reset:
  # u = R0^T e_z;  up(t) = e_z . R(t) u   (1 standing, 0 at 90 deg tilt)
  import numpy as _np
  up_axis = jnp.asarray(_np.asarray(d0.xmat[pelvis]).T @ _np.array(
      [0.0, 0.0, 1.0]), jnp.float32)

  def score(params):
    """Distance + survival for one gain vector (fixed-length scan)."""
    cp = reflex.expand_params(params)

    def tick(carry, _):
      d, s, alive, fall_x, t_alive = carry
      prev_x = d.xpos[pelvis, 0]
      d, s = walker.step(d, s, cp)
      h = d.xpos[pelvis, 2]
      # pelvis tilt vs the reset orientation: fall past ~60 deg
      up = d.xmat[pelvis, 2, :] @ up_axis
      # physical-sanity gate: a diverging sim can fly through the valid
      # height band and bank metres of "distance" in one tick — cap
      # per-tick displacement at 10 m/s and require finite, bounded
      # joint velocities before crediting anything
      sane = (jnp.all(jnp.isfinite(d.qvel))
              & (jnp.max(jnp.abs(d.qvel)) < 100.0)
              & (jnp.abs(d.xpos[pelvis, 0] - prev_x) < 0.1))
      ok = (h > 0.65) & (h < 1.25) & (up > 0.5) & sane
      alive = alive & ok
      fall_x = jnp.where(alive, d.xpos[pelvis, 0], fall_x)
      t_alive = t_alive + alive
      return (d, s, alive, fall_x, t_alive), None

    init = (d0, s0, jnp.asarray(True), jnp.asarray(0.0, jnp.float32),
            jnp.asarray(0, jnp.int32))
    (d, s, alive, fall_x, t_alive), _ = jax.lax.scan(
        tick, init, (), length=args.ticks)
    # distance until fall + 0.5 cm/tick survival shaping
    return fall_x + 0.005 * t_alive, t_alive

  batch_score = jax.jit(jax.vmap(score))

  rng = np.random.default_rng(args.seed)
  mu = np.ones(reflex.N_PARAMS)
  if args.init:
    mu = np.load(args.init)["params"]
  sigma = np.full(reflex.N_PARAMS, args.sigma)

  best = {"fitness": -np.inf, "params": mu.copy(), "t_alive": 0}
  history = []
  for gen in range(args.generations):
    t0 = time.time()
    cand = mu[None] + sigma[None] * rng.standard_normal(
        (args.pop, reflex.N_PARAMS))
    cand = np.clip(cand, -2.0, 4.0)
    cand[0] = best["params"]          # elitism: keep the best ever
    fit, t_alive = map(np.asarray, batch_score(jnp.asarray(
        cand, jnp.float32)))
    order = np.argsort(-fit)
    elite = cand[order[:args.elite]]
    mu = elite.mean(0)
    sigma = 0.9 * sigma + 0.1 * (elite.std(0) + 0.01)
    if fit[order[0]] > best["fitness"]:
      best = {"fitness": float(fit[order[0]]),
              "params": cand[order[0]].copy(),
              "t_alive": int(t_alive[order[0]])}
    rec = dict(gen=gen, best=float(fit[order[0]]),
               elite_mean=float(fit[order[:args.elite]].mean()),
               best_ever=best["fitness"],
               best_t_alive=best["t_alive"],
               best_alive_s=best["t_alive"] * 0.01,
               wall=round(time.time() - t0, 1))
    history.append(rec)
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, params=best["params"],
             fitness=best["fitness"], t_alive=best["t_alive"],
             mu=mu, sigma=sigma)
  with open(args.out.replace(".npz", "_history.json"), "w") as f:
    json.dump(history, f, indent=1)
  print("saved", args.out, "best fitness", best["fitness"],
        "alive", best["t_alive"] * 0.01, "s")


if __name__ == "__main__":
  main()
