"""examine_sim CLI: load a raw MJCF model and step the JAX engine on it.

Capability parity with the reference's examine_sim
(/root/reference/myosuite/utils/examine_sim.py:21): quick interactive
sanity check of a model file outside any task env — compile, step with
random or zero ctrl, report state statistics, optionally write a debug
video through the host renderer.

Usage:
  python -m myosuite_mjx_tpu.utils.examine_sim --model_path <xml> \
      [--horizon 100] [--ctrl random|zero] [--video out.mp4]
"""
from __future__ import annotations

import argparse
import functools
import time


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--model_path", "-m", required=True)
  ap.add_argument("--horizon", type=int, default=100)
  ap.add_argument("--ctrl", default="random", choices=("random", "zero"))
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--video", default=None,
                  help="write a qpos-replay video here (host renderer)")
  args = ap.parse_args(argv)

  import jax
  import jax.numpy as jnp
  import numpy as np

  from myosuite_mjx_tpu.engine import data as edata
  from myosuite_mjx_tpu.engine import forward
  from myosuite_mjx_tpu.engine import model as emodel

  m = emodel.load_model(args.model_path, dtype=np.float64)
  print(f"model: nq={m.nq} nv={m.nv} nu={m.nu} na={m.na} "
        f"nbody={m.nbody} ngeom={m.ngeom} ntendon={m.ntendon}")
  d = edata.make_data(m, dtype=jnp.float64)
  step = jax.jit(functools.partial(forward.step, m))
  key = jax.random.PRNGKey(args.seed)
  frames = []
  t0 = time.time()
  for t in range(args.horizon):
    if args.ctrl == "random":
      key, k = jax.random.split(key)
      ctrl = jax.random.uniform(k, (m.nu,), jnp.float64, 0.0, 1.0)
    else:
      ctrl = jnp.zeros((m.nu,), jnp.float64)
    d = step(d.replace(ctrl=ctrl))
    if args.video:
      frames.append(np.asarray(d.qpos))
  qpos = np.asarray(d.qpos)
  wall = time.time() - t0
  print(f"stepped {args.horizon} x {m.opt.timestep*1e3:.0f} ms "
        f"in {wall:.2f} s wall")
  print(f"qpos range [{qpos.min():.4f}, {qpos.max():.4f}] "
        f"finite={np.isfinite(qpos).all()} "
        f"ncon_active={int(d.ne_active)} "
        f"ncon_dropped={int(d.ncon_dropped)}")
  if args.video:
    from myosuite_mjx_tpu.utils.render import render_qpos_frames
    out = render_qpos_frames(args.model_path, frames, args.video)
    print(f"wrote {out}")


if __name__ == "__main__":
  main()
