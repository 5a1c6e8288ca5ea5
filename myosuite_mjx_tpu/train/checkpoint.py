"""Checkpoint/resume for training state (orbax).

Capability parity with the reference's trainer-side checkpointing
(SB3 CheckpointCallback/resume, agents/sb3_job_script.py:85-118; brax
model.save_params) — here a single orbax checkpoint of the full PPO
TrainState pytree (params + optimizer + env states + PRNG), which makes
resume exact. ``orbax`` is imported on the first save or restore, so
training without checkpoints does not need it installed.
"""
from __future__ import annotations

import os

import jax


def _ocp():
  try:
    import orbax.checkpoint as ocp
  except ImportError as e:
    raise ImportError(
        "checkpointing needs the orbax-checkpoint package "
        "(pip install orbax-checkpoint); training without "
        "--checkpoint-dir/--resume does not") from e
  return ocp


def _prune_empty(tree):
  """orbax rejects zero-size arrays; drop them (restored from template)."""
  return jax.tree.map(
      lambda x: None if getattr(x, "size", 1) == 0 else x, tree)


def save(path: str, train_state) -> None:
  path = os.path.abspath(path)
  ckptr = _ocp().StandardCheckpointer()
  ckptr.save(path, _prune_empty(train_state), force=True)
  ckptr.wait_until_finished()


def _key_name(k):
  for attr in ("name", "key", "idx"):
    if hasattr(k, attr):
      return str(getattr(k, attr))
  return str(k)


def _partial_restore(ckptr, path, abstract, template):
  """Restore a checkpoint whose tree is MISSING leaves the template has
  (Data-schema growth between rounds): leaves absent from the checkpoint
  keep their template value; missing 'params' leaves raise (that would
  silently reinitialize a layer)."""
  ocp = _ocp()
  meta = ckptr.metadata(path)
  meta_tree = meta
  for attr in ("item_metadata", "tree"):
    if hasattr(meta_tree, attr):
      meta_tree = getattr(meta_tree, attr)

  def present(kp):
    node = meta_tree
    for k in kp:
      name = _key_name(k)
      if isinstance(node, dict):
        if name not in node:
          return False
        node = node[name]
      elif isinstance(node, (list, tuple)) and name.isdigit():
        if int(name) >= len(node):
          return False
        node = node[int(name)]
      else:
        child = getattr(node, name, None)
        if child is None:
          return False
        node = child
    return True

  flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
  missing = [kp for kp, _ in flat if not present(kp)]
  miss_strs = [jax.tree_util.keystr(kp) for kp in missing]
  if any("params" in s for s in miss_strs):
    raise RuntimeError(
        f"checkpoint {path} is missing parameter leaves: {miss_strs}")
  print(f"partial restore: keeping template values for {miss_strs}")
  miss_set = set(miss_strs)
  # the abstract tree keeps the template's exact structure with
  # ocp.PLACEHOLDER at leaves the checkpoint lacks; PyTreeRestore with
  # partial_restore skips those (returned as Ellipsis) and we backfill
  # them from the template
  # None leaves (zero-size arrays pruned before save) also become
  # PLACEHOLDER: they were never written, and the PyTree handler asserts
  # on None metadata entries under partial_restore
  abstract2 = jax.tree_util.tree_map_with_path(
      lambda kp, v: ocp.PLACEHOLDER
      if (v is None or jax.tree_util.keystr(kp) in miss_set) else v,
      abstract, is_leaf=lambda x: x is None)
  pt = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
  restored = pt.restore(
      path, args=ocp.args.PyTreeRestore(item=abstract2,
                                        partial_restore=True))
  return jax.tree.map(
      lambda t, r: t if r is ocp.PLACEHOLDER else r, template, restored,
      is_leaf=lambda x: x is ocp.PLACEHOLDER)


def restore(path: str, template):
  """Restore into the shape/dtype structure of ``template``.

  Forward-compatible across Data-schema growth: leaves present in the
  template but absent from the checkpoint (e.g. a Data field added in a
  later round — contact_force_vec) are kept from the template instead of
  failing the restore; every restored value still must match the
  template's shape/dtype. Missing PARAMS would silently reinitialize a
  layer, so restores that fall back for anything under 'params' raise.
  """
  path = os.path.abspath(path)
  ocp = _ocp()
  ckptr = ocp.StandardCheckpointer()
  abstract = jax.tree.map(
      ocp.utils.to_shape_dtype_struct, _prune_empty(template))
  try:
    restored = ckptr.restore(path, abstract)
  except Exception:
    restored = _partial_restore(ckptr, path, abstract, template)
  # reinsert zero-size leaves from the template
  return jax.tree.map(
      lambda t, r: t if getattr(t, "size", 1) == 0 else r,
      template, restored,
      is_leaf=lambda x: x is None or getattr(x, "size", 1) == 0)


def save_params(path: str, params) -> None:
  """Policy-only export (pickle) for examine_env-style consumers."""
  import pickle
  with open(path, "wb") as f:
    pickle.dump(jax.tree.map(lambda x: __import__("numpy").asarray(x),
                             params), f)
