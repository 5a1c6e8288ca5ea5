"""Import a reference-trained NPG policy into the zoo and score it.

The reference distributes mjrl/NPG policies as torch pickles
(/root/reference/myosuite/agents/baslines_NPG/<env_id>/.../iterations/
best_policy.pickle, consumed by utils/examine_env.py --policy_path). Here
we extract the raw MLP weights + observation/action transformations from
such a pickle (no mjrl install needed — stub unpickling), freeze them as a
``policy-mlp-v1`` zoo snapshot, and roll the policy out in OUR engine.

This is a cross-engine transfer experiment, not just a convenience: the
policy was trained against 2022-era MuJoCo C physics, so its score inside
the JAX engine measures end-to-end physics+obs parity at the task
level. (The reference's own reflex baseline demonstrates such transfers
can fail across model revisions — see agents/reflex.py docstring.)

Usage:
  python tools/import_reference_policy.py --env myoHandPoseFixed-v0 \
      [--save] [--episodes 64]
  python tools/import_reference_policy.py --all   # sweep every NPG env
"""
import argparse
import glob
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

NPG_ROOT = os.path.join(
    os.environ.get("MYOSUITE_TPU_REFERENCE", "/root/reference"),
    "myosuite", "agents", "baslines_NPG")


class _StubUnpickler(pickle.Unpickler):
  """Unpickle mjrl objects without mjrl: unknown classes become shells
  whose __dict__ still carries the real torch tensors."""

  def find_class(self, module, name):
    try:
      return super().find_class(module, name)
    except (ImportError, AttributeError):
      cls = type(name, (), {})
      cls.__module__ = module
      return cls


def find_policy_pickle(env_id: str) -> str:
  pat = os.path.join(NPG_ROOT, env_id, "*", "*", "iterations",
                     "best_policy.pickle")
  hits = sorted(glob.glob(pat))
  if not hits:
    raise FileNotFoundError(f"no NPG pickle for {env_id} under {NPG_ROOT}")
  return hits[0]


def extract(path: str) -> dict:
  """Pull (layers, transformations, log_std) out of an mjrl MLP pickle."""
  with open(path, "rb") as f:
    pol = _StubUnpickler(f).load()
  model = pol.__dict__["model"]
  md = model.__dict__
  fc = md["_modules"]["fc_layers"]
  linears = list(fc._modules.values())
  layers = []
  for lin in linears:
    w = lin._parameters["weight"].detach().numpy()  # torch: [out, in]
    b = lin._parameters["bias"].detach().numpy()
    layers.append((w.T.astype(np.float32), b.astype(np.float32)))

  def arr(x, default):
    if x is None:
      return default
    return np.asarray(getattr(x, "detach", lambda: x)().numpy()
                      if hasattr(x, "detach") else x, np.float32)

  obs_dim = layers[0][0].shape[0]
  act_dim = layers[-1][0].shape[1]
  return dict(
      layers=layers,
      in_shift=arr(md.get("in_shift"), np.zeros(obs_dim, np.float32)),
      in_scale=arr(md.get("in_scale"), np.ones(obs_dim, np.float32)),
      out_shift=arr(md.get("out_shift"), np.zeros(act_dim, np.float32)),
      out_scale=arr(md.get("out_scale"), np.ones(act_dim, np.float32)),
      nonlinearity="relu" if md.get("nonlinearity") in ("relu",) else "tanh",
      log_std=arr(pol.__dict__.get("log_std"), np.zeros(act_dim)),
  )


def evaluate(env_id: str, policy, episodes: int = 64) -> dict:
  """Deterministic batched rollout in our engine; reference
  evaluate_success contract (env_base.py:744-770): an episode succeeds
  when solved on more than 5 steps."""
  import jax
  import jax.numpy as jnp
  from myosuite_mjx_tpu import envs

  # Reduced-precision matmuls (TF32, the GPU's f32 default) perturb a
  # feedback policy riding a solved-threshold boundary. Physics + policy
  # both run f32 here, matching the trainers (ppo.train wraps the same
  # context).
  with jax.default_matmul_precision("highest"):
    env = envs.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(0), episodes)
    st = jax.jit(jax.vmap(env.reset))(keys)
    step = jax.jit(jax.vmap(env.autoreset_step))
    act_fn = jax.jit(jax.vmap(policy.act))
    solved_steps = jnp.zeros((episodes,))
    rew_sum = jnp.zeros((episodes,))
    solved_any = jnp.zeros((episodes,), bool)
    for _ in range(env.horizon):
      st = step(st, act_fn(st.obs))
      solved = st.info["solved"].astype(jnp.float32)
      solved_steps = solved_steps + solved
      solved_any = solved_any | st.info["solved"]
      rew_sum = rew_sum + st.info["rwd_dense"]
    return dict(
        eval_success=float((solved_steps > 5).mean()),
        solved_any=float(solved_any.mean()),
        solved_frac=float(solved_steps.mean()) / env.horizon,
        return_mean=float(rew_sum.mean()),
        episodes=episodes,
    )


def run_one(env_id: str, episodes: int, save: bool) -> dict:
  from myosuite_mjx_tpu.train import zoo
  src = find_policy_pickle(env_id)
  ex = extract(src)
  snap = dict(
      format="myosuite_mjx_tpu/policy-mlp-v1", env_id=env_id,
      layers=ex["layers"], in_shift=ex["in_shift"],
      in_scale=ex["in_scale"], out_shift=ex["out_shift"],
      out_scale=ex["out_scale"], nonlinearity=ex["nonlinearity"],
      source=os.path.relpath(src, NPG_ROOT))
  policy = zoo.Policy(snap)
  res = evaluate(env_id, policy, episodes)
  res["env"] = env_id
  res["source"] = snap["source"]
  if save:
    path = os.path.join(zoo.ZOO_DIR, f"{env_id}.pkl")
    zoo.save_mlp_snapshot(path, env_id, ex["layers"], ex["in_shift"],
                          ex["in_scale"], ex["out_shift"], ex["out_scale"],
                          nonlinearity=ex["nonlinearity"],
                          source=snap["source"])
    with open(path[:-4] + "_metrics.json", "w") as f:
      json.dump({"env": env_id, "imported_from": snap["source"],
                 "eval": res}, f, indent=1)
    res["saved"] = path
  return res


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--env", default=None)
  ap.add_argument("--all", action="store_true",
                  help="evaluate every NPG env with a registered twin")
  ap.add_argument("--episodes", type=int, default=64)
  ap.add_argument("--save", action="store_true",
                  help="freeze the imported policy into the zoo")
  ap.add_argument("--cpu", action="store_true",
                  help="force CPU JAX (leave the GPU to training jobs)")
  args = ap.parse_args()

  if args.cpu:
    import jax
    jax.config.update("jax_platforms", "cpu")

  from myosuite_mjx_tpu.utils import compile_cache
  compile_cache.enable()

  if args.all:
    from myosuite_mjx_tpu import envs as _envs
    registered = set(_envs.registry_ids())
    ids = [d for d in sorted(os.listdir(NPG_ROOT))
           if os.path.isdir(os.path.join(NPG_ROOT, d))]
    for env_id in ids:
      if env_id not in registered:
        print(json.dumps({"env": env_id, "skip": "not registered"}))
        continue
      try:
        print(json.dumps(run_one(env_id, args.episodes, args.save)),
              flush=True)
      except Exception as e:  # noqa: BLE001 — sweep must report, not die
        print(json.dumps({"env": env_id, "error": repr(e)}), flush=True)
    return
  print(json.dumps(run_one(args.env, args.episodes, args.save), indent=1))


if __name__ == "__main__":
  main()
