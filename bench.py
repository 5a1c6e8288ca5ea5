"""Headline benchmark: myoHand FULL env-steps/s on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...}.
Baseline = the north-star 1M aggregate env-steps/s target from BASELINE.md
(the reference publishes no hardware numbers of its own).

The headline measures the complete environment step of a *registered* hand
env (myoHandPoseFixed-v0): frame_skip physics substeps + obs assembly +
reward dict + termination + autoreset, i.e. ``jit(vmap(env.autoreset_step))``
— the quantity an RL loop consumes. It is reported at PHYSICS-STEP
granularity (control-steps/s x frame_skip) because the baseline's
"env step" is the reference MJX env.step = one physics step
(mjx/play.py:37-47); control-step rate is in the same JSON line. The bare
engine step (one physics substep of myohand.xml, no task overhead — the
metric benched in rounds 1-2) is available as ``--engine``; ``--engine
--model synthetic`` (the default) runs the committed synthetic hand scene,
which needs no asset tree.

Alongside steps/s the bench prints FLOPs/step, HBM bytes/step, and the
derived MFU / HBM utilization from ``compiled.cost_analysis()`` against the
card's published peaks (``PEAKS``, keyed by ``device_kind``; a device not in
the table is an error, never a default). Caveat:
XLA cost analysis counts while/scan loop *bodies once* (not x trip count)
and HLO-level bytes overcount fused intermediates, so both are approximate;
they are printed to make every optimization's direction accountable, not as
absolute truth. Wall-clock steps/s is the ground truth.

Methodology: one jitted batched env step with donated input, dependency-
chained K times (state feeds state, so all K executions serialize
on-device); wall clock over the chain / (B*K), ended by block_until_ready.

Run: python bench.py [--env myoHandPoseFixed-v0] [--batch N] [--steps K]
     python bench.py --engine [--model synthetic|finger|hand]  # physics step
"""
import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# persistent compile cache: the hand env step takes minutes to compile
from myosuite_mjx_tpu.utils import compile_cache  # noqa: E402
compile_cache.enable()

from myosuite_mjx_tpu.models import synthetic  # noqa: E402
from myosuite_mjx_tpu.models.assets import asset  # noqa: E402

MODELS = {
    "synthetic": synthetic.NPZ_PATH,
    "finger": asset("simhive/myo_sim/finger/myofinger_v0.xml"),
    "hand": asset("simhive/myo_sim/hand/myohand.xml"),
}

BASELINE_STEPS_PER_S = 1_000_000.0  # BASELINE.md north star (aggregate)

# Published peaks by jax device_kind: (f32 FLOP/s outside the tensor cores,
# HBM bytes/s). NVIDIA H100 data sheet, SXM part, 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def peaks() -> tuple[float, float]:
  kind = jax.devices()[0].device_kind
  if kind not in PEAKS:
    raise SystemExit(f"no published peaks for device {kind!r}; add them "
                     "to bench.PEAKS with their source")
  return PEAKS[kind]


def _prec(fn):
  def wrapped(*args):
    # f32 matmul precision: the Newton/implicit-damping dense solves need
    # more than TF32 (the GPU's f32 matmul default)
    with jax.default_matmul_precision("highest"):
      return fn(*args)
  return wrapped


def _cost(compiled):
  ca = compiled.cost_analysis()
  if isinstance(ca, list):
    ca = ca[0] if ca else {}
  return (float(ca.get("flops", 0.0) or 0.0),
          float(ca.get("bytes accessed", 0.0) or 0.0))


def _report(metric, sps, flops_step, bytes_step, extra):
  peak_flops, peak_hbm = peaks()
  dev = jax.devices()[0]
  out = {
      "metric": metric,
      "value": round(sps, 1),
      "unit": "env-steps/s/gpu",
      "vs_baseline": round(sps / BASELINE_STEPS_PER_S, 4),
      "flops_per_step": round(flops_step, 1),
      "hbm_bytes_per_step": round(bytes_step, 1),
      "mfu_pct": round(100.0 * flops_step * sps / peak_flops, 3),
      "hbm_util_pct": round(100.0 * bytes_step * sps / peak_hbm, 1),
      "device": {"platform": dev.platform, "kind": dev.device_kind,
                 "count": len(jax.devices())},
  }
  out.update(extra)
  print(json.dumps(out))


def bench_env(args):
  from myosuite_mjx_tpu.envs import registry
  env = registry.make(args.env)
  B, K = args.batch, args.steps
  keys = jax.random.split(jax.random.PRNGKey(0), B)
  reset = jax.jit(_prec(jax.vmap(env.reset)))
  step = jax.jit(_prec(jax.vmap(env.autoreset_step)), donate_argnums=0)

  st = reset(keys)
  act = jnp.zeros((B, env.action_dim), jnp.float32)
  # compile + settle into steady state (with autoreset churn)
  st = step(st, act)
  for _ in range(5):
    st = step(st, act)
  assert not np.isnan(np.asarray(st.obs)).any(), "NaN in warmup rollout"

  if args.profile:
    # device-level trace (op timeline / HBM traffic) for xprof/tensorboard
    with jax.profiler.trace(args.profile):
      for _ in range(5):
        st = step(st, act)
      jax.block_until_ready(st.reward)
    print(f"# profiler trace written to {args.profile}", file=sys.stderr)

  times = []
  for _ in range(3):
    t0 = time.time()
    for _ in range(K):
      st = step(st, act)
    jax.block_until_ready(st.reward)
    times.append(time.time() - t0)
  assert not np.isnan(np.asarray(st.obs)).any(), "NaN in benchmark rollout"
  dt = min(times)
  sps = B * K / dt

  nodon = jax.jit(_prec(jax.vmap(env.autoreset_step)))
  flops, bytes_ = _cost(nodon.lower(st, act).compile())
  # Headline in BASELINE granularity: the reference MJX env's step() is ONE
  # physics step (mjx/play.py:37-47), so the 1M-aggregate north star counts
  # physics-rate env steps. Our env packs frame_skip substeps per control
  # step; the comparable number is control-steps/s * frame_skip, measured
  # through the FULL env pipeline (obs/reward/termination/autoreset
  # included). Control-step rate is reported alongside.
  fs = env.frame_skip
  _report("myohand_physics_steps_per_s", sps * fs,
          flops / (B * fs), bytes_ / (B * fs), {
              "granularity": "physics-step; the 1M north-star counts raw "
                             "mjx.step calls (mjx/play.py:37-47). The "
                             "reference's MJX *env* packs n_frames=5 "
                             "physics steps per env.step (myodm_v0.py:"
                             "45-46); at that granularity this run is "
                             "env_steps_per_s_at_n_frames5.",
              "control_steps_per_s": round(sps, 1),
              "env_steps_per_s_at_n_frames5": round(sps * fs / 5.0, 1),
              "frame_skip": fs,
              "batch": B,
              "env": args.env,
              "pipeline": "full env step (obs+reward+termination+autoreset)",
          })


def bench_engine(args):
  from myosuite_mjx_tpu.engine import data as edata
  from myosuite_mjx_tpu.engine import forward
  from myosuite_mjx_tpu.engine import model as emodel

  m = emodel.load_model(MODELS[args.model], dtype=np.float32)
  B, K = args.batch, args.steps
  with jax.default_device(jax.local_devices(backend="cpu")[0]):
    d0 = edata.make_data(m, dtype=jnp.float32)
  batch0 = jax.device_put(
      jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0),
      jax.devices()[0])

  vstep = jax.vmap(functools.partial(forward.step, m))
  step = jax.jit(_prec(vstep), donate_argnums=0)

  out = step(batch0)
  for _ in range(5):
    out = step(out)
  assert not np.isnan(np.asarray(out.qpos)).any(), "NaN in warmup rollout"

  times = []
  for _ in range(3):
    t0 = time.time()
    for _ in range(K):
      out = step(out)
    jax.block_until_ready(out.qpos)
    times.append(time.time() - t0)
  assert not np.isnan(np.asarray(out.qpos)).any(), "NaN in benchmark"
  dt = min(times)
  sps = B * K / dt
  flops, bytes_ = _cost(jax.jit(_prec(vstep)).lower(out).compile())
  _report(f"myo{args.model}_engine_steps_per_s", sps, flops / B, bytes_ / B,
          {"batch": B})


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--env", default="myoHandPoseFixed-v0")
  ap.add_argument("--engine", action="store_true",
                  help="bench the bare physics step instead of the env step")
  ap.add_argument("--model", default="synthetic", choices=sorted(MODELS))
  ap.add_argument("--batch", type=int, default=4096)
  ap.add_argument("--steps", type=int, default=20)
  ap.add_argument("--profile", default=None, metavar="DIR",
                  help="capture a jax.profiler device trace of 5 env "
                       "steps into DIR (view with tensorboard/xprof)")
  args = ap.parse_args()
  peaks()  # fail before compiling on a device without published peaks
  if args.engine:
    bench_engine(args)
  else:
    bench_env(args)


if __name__ == "__main__":
  main()
