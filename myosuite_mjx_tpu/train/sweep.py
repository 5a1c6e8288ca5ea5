"""Multi-env x multi-seed sweep launcher.

Capability twin of the reference's job-farm generators
(/root/reference/myosuite/agents/train_myosuite.sh:1-50 builds an env-list
x config sweep; hydra_sb3_launcher.py + submitit fan it out to a cluster).
Shape: one process owns the GPU, so the sweep is a sequential
loop of single-run trainings (each already vmap-batched over thousands of
envs); each run gets its own artifact directory
<out>/<env_id>_<algo>_s<seed>/ with metrics.jsonl, tensorboard events and
checkpoints, and the sweep writes a summary.json at the end.

Usage:
  python -m myosuite_mjx_tpu.train.sweep \
      --envs myoFingerPoseFixed-v0,myoElbowPose1D6MRandom-v0 \
      --seeds 0,1 --out /tmp/sweep -- --total-steps 300000 --num-envs 512
  python -m myosuite_mjx_tpu.train.sweep --envs @envs.txt --seeds 0 ...
      (one env ID per line, '#' comments)

Everything after ``--`` is forwarded verbatim to train.cli for each run.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _parse_envs(spec: str) -> list:
  if spec.startswith("@"):
    with open(spec[1:]) as f:
      return [ln.strip() for ln in f
              if ln.strip() and not ln.strip().startswith("#")]
  return [e for e in spec.split(",") if e]


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(
      description=__doc__.split("\n")[0],
      epilog="arguments after -- are forwarded to train.cli")
  ap.add_argument("--envs", required=True,
                  help="comma-separated env IDs, or @file with one per line")
  ap.add_argument("--seeds", default="0",
                  help="comma-separated seeds, e.g. 0,1,2")
  ap.add_argument("--algo", default="ppo", choices=("ppo", "sac"))
  ap.add_argument("--out", required=True, help="sweep artifact root")
  ap.add_argument("--keep-going", action="store_true",
                  help="continue the sweep past a failed run (failure is "
                       "recorded in summary.json) instead of aborting")
  return ap


def main(argv=None) -> list:
  import sys
  argv = list(sys.argv[1:] if argv is None else argv)
  if "--" in argv:
    split = argv.index("--")
    argv, fwd = argv[:split], argv[split + 1:]
  else:
    fwd = []
  args = build_parser().parse_args(argv)

  from myosuite_mjx_tpu.train import cli

  envs_list = _parse_envs(args.envs)
  seeds = [int(s) for s in args.seeds.split(",")]
  os.makedirs(args.out, exist_ok=True)
  results = []
  for env_id in envs_list:
    for seed in seeds:
      run_dir = os.path.join(args.out, f"{env_id}_{args.algo}_s{seed}")
      run_args = [
          "--env", env_id, "--algo", args.algo, "--seed", str(seed),
          "--logdir", run_dir,
          "--checkpoint-dir", os.path.join(run_dir, "ckpt"),
          "--metrics-out", os.path.join(run_dir, "history.json"),
      ] + fwd
      print(f"[sweep] {env_id} seed={seed} -> {run_dir}", flush=True)
      t0 = time.time()
      rec = {"env": env_id, "seed": seed, "dir": run_dir}
      try:
        cli.main(run_args)
        rec["status"] = "ok"
      except SystemExit as e:  # argparse/validation failures
        rec["status"] = f"exit:{e.code}"
        if not args.keep_going:
          raise
      except Exception as e:  # noqa: BLE001 - recorded, optionally re-raised
        rec["status"] = f"error:{type(e).__name__}: {e}"
        if not args.keep_going:
          raise
      rec["wall_s"] = round(time.time() - t0, 1)
      results.append(rec)
      with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
  print(f"[sweep] done: {sum(r['status'] == 'ok' for r in results)}/"
        f"{len(results)} runs ok -> {args.out}/summary.json", flush=True)
  return results


if __name__ == "__main__":
  main()
