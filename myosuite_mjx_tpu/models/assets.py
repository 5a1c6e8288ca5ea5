"""Asset resolution: the MyoSuite asset tree, a shadow tree of processed
scenes, and MyoDM object-scene processing.

The reference fetches its model assets (simhive) from git and instantiates
MyoDM scenes by substituting OBJECT_NAME into a template XML next to the
original (/root/reference/myosuite/envs/myo/myodm/myodm_v0.py:44-55). We
keep the asset tree read-only and materialize processed scenes in a shadow
tree under the temp directory, with symlinks so relative includes resolve.
Scenes are materialized only when an env is made, never at import.
"""
from __future__ import annotations

import os
import tempfile

# The MyoSuite checkout holding simhive/ and envs/myo/assets/.
ASSET_ROOT = os.environ.get(
    "MYOSUITE_TPU_ASSETS", "/root/reference/myosuite")

SHADOW_ROOT = os.environ.get(
    "MYOSUITE_TPU_SHADOW",
    os.path.join(tempfile.gettempdir(), "myosuite_tpu_assets"))


def asset(relpath: str) -> str:
  return os.path.join(ASSET_ROOT, relpath)


def require_tree() -> None:
  """Raise one clear error when the asset tree is absent."""
  if not os.path.isdir(os.path.join(ASSET_ROOT, "simhive")):
    raise FileNotFoundError(
        f"MyoSuite asset tree not found at {ASSET_ROOT!r} (no simhive/ "
        "there). Every registered Myo task needs it: set "
        "MYOSUITE_TPU_ASSETS to a MyoSuite checkout.")


def _ensure_shadow() -> str:
  require_tree()
  hand_dir = os.path.join(SHADOW_ROOT, "envs/myo/assets/hand")
  os.makedirs(hand_dir, exist_ok=True)
  link = os.path.join(SHADOW_ROOT, "simhive")
  if not os.path.islink(link) and not os.path.exists(link):
    os.symlink(os.path.join(ASSET_ROOT, "simhive"), link)
  # sibling includes (tabletop scene, textures, ...) resolve via symlinks
  src_dir = os.path.join(ASSET_ROOT, "envs/myo/assets/hand")
  for fname in os.listdir(src_dir):
    dst = os.path.join(hand_dir, fname)
    if not os.path.islink(dst) and not os.path.exists(dst):
      os.symlink(os.path.join(src_dir, fname), dst)
  return hand_dir


def object_scene_xml(object_name: str,
                     template: str = "myohand_object.xml") -> str:
  """Materialize the MyoDM hand+object scene for ``object_name``."""
  hand_dir = _ensure_shadow()
  out_path = os.path.join(
      hand_dir, f"{template[:-4]}_{object_name}.xml")
  if not os.path.exists(out_path):
    src = os.path.join(ASSET_ROOT, "envs/myo/assets/hand", template)
    with open(src) as f:
      xml = f.read().replace("OBJECT_NAME", object_name)
    with open(out_path, "w") as f:
      f.write(xml)
  return out_path


def myodm_clip(motion_file: str) -> str:
  return os.path.join(ASSET_ROOT, "envs/myo/myodm/data", motion_file)


def _write_prism_stl(path: str, center, radius: float, half_y: float,
                     nsides: int = 16) -> None:
  """Binary STL of a convex prism along local Y (placeholder OSL housing)."""
  import struct
  import numpy as np

  cx, cy, cz = center
  ang = np.linspace(0, 2 * np.pi, nsides, endpoint=False)
  lo = np.stack([cx + radius * np.cos(ang), np.full(nsides, cy - half_y),
                 cz + radius * np.sin(ang)], axis=1)
  hi = lo.copy()
  hi[:, 1] = cy + half_y
  tris = []
  for i in range(nsides):
    j = (i + 1) % nsides
    tris += [(lo[i], lo[j], hi[i]), (hi[i], lo[j], hi[j])]
    tris += [((cx, cy - half_y, cz), lo[j], lo[i]),
             ((cx, cy + half_y, cz), hi[i], hi[j])]
  with open(path, "wb") as f:
    f.write(b"\0" * 80)
    f.write(struct.pack("<I", len(tris)))
    for a, b, c in tris:
      n = np.cross(np.subtract(b, a), np.subtract(c, a))
      n = n / max(np.linalg.norm(n), 1e-12)
      f.write(struct.pack("<12fH", *n, *a, *b, *c, 0))


def osl_runtrack_xml() -> str:
  """Materialize the OSL RunTrack scene with placeholder prosthesis meshes.

  The reference simhive checkout references osl_knee_v2.stl and
  osl_ankle_v2.stl (simhive/myo_sim/osl/assets/myolegs_osl_assets.xml:
  113-114) which are absent from the pinned asset tree, so the scene cannot
  compile as-is. All prosthesis inertials are explicit <inertial> tags
  (myolegs_osl_chain.xml:190,198) — the meshes contribute only collision/
  visual shape — so we substitute convex prisms sized from the published
  inertia tensors (solid-cylinder inversion: knee r~0.05 h~0.18 about the
  inertial center; ankle r~0.05 h~0.13).
  """
  leg_dir = _shadow_tree("envs/myo/assets/leg")
  _shadow_tree("envs/myo/assets")  # sibling includes (myosuite_track.xml)
  out_path = os.path.join(leg_dir, "myoosl_runtrack_tpu.xml")
  if os.path.exists(out_path):
    return out_path

  mesh_dir = os.path.join(SHADOW_ROOT, "osl_meshes")
  os.makedirs(mesh_dir, exist_ok=True)
  knee_stl = os.path.join(mesh_dir, "osl_knee_placeholder.stl")
  ankle_stl = os.path.join(mesh_dir, "osl_ankle_placeholder.stl")
  _write_prism_stl(knee_stl, (0.004, -0.059, 0.009), 0.048, 0.09)
  _write_prism_stl(ankle_stl, (-0.007, 0.045, 0.009), 0.048, 0.065)

  src_assets = os.path.join(
      ASSET_ROOT, "simhive/myo_sim/osl/assets/myolegs_osl_assets.xml")
  with open(src_assets) as f:
    assets = f.read()
  assets = assets.replace(
      '<mesh file="../myo_sim/meshes/osl_knee_v2.stl" '
      'name="osl_knee_assembly_geom_1_osl_knee_v2"/>',
      f'<mesh file="{knee_stl}" '
      'name="osl_knee_assembly_geom_1_osl_knee_v2"/>')
  assets = assets.replace(
      '<mesh file="../myo_sim/meshes/osl_ankle_v2.stl" '
      'name="osl_ankle_assembly_geom_1_osl_ankle_v2"/>',
      f'<mesh file="{ankle_stl}" '
      'name="osl_ankle_assembly_geom_1_osl_ankle_v2"/>')
  assert knee_stl in assets and ankle_stl in assets, (
      "reference myolegs_osl_assets.xml mesh entries changed")
  patched_assets = os.path.join(leg_dir, "myolegs_osl_assets_tpu.xml")
  with open(patched_assets, "w") as f:
    f.write(assets)

  src_scene = os.path.join(
      ASSET_ROOT, "envs/myo/assets/leg/myoosl_runtrack.xml")
  with open(src_scene) as f:
    scene = f.read()
  scene = scene.replace(
      "../../../../simhive/myo_sim/osl/assets/myolegs_osl_assets.xml",
      "myolegs_osl_assets_tpu.xml")
  with open(out_path, "w") as f:
    f.write(scene)
  return out_path


def _shadow_tree(rel_dir: str) -> str:
  """Mirror one reference asset directory into the shadow tree (symlinked
  files, so relative includes keep resolving); returns the shadow dir."""
  require_tree()
  dst_dir = os.path.join(SHADOW_ROOT, rel_dir)
  os.makedirs(dst_dir, exist_ok=True)
  link = os.path.join(SHADOW_ROOT, "simhive")
  if not os.path.islink(link) and not os.path.exists(link):
    os.symlink(os.path.join(ASSET_ROOT, "simhive"), link)
  src_dir = os.path.join(ASSET_ROOT, rel_dir)
  for fname in os.listdir(src_dir):
    src = os.path.join(src_dir, fname)
    dst = os.path.join(dst_dir, fname)
    if os.path.isfile(src) and not os.path.islink(dst) \
       and not os.path.exists(dst):
      os.symlink(src, dst)
  return dst_dir


def sar_scene_xml(condim: int = 4) -> str:
  """Materialize the SAR-reorient scene with one geom per candidate type.

  The reference mutates the object's geom *type* per episode
  (reorient_sar_v0.py:236-248 writes model.geom_type). Geom type is static
  shape information under XLA, so the scene instead carries all four
  candidate geoms (capsule/ellipsoid/cylinder/box) on the Object body; the
  per-episode overlay sets the active geom's size from the task table and
  shrinks the inactive ones to epsilon (a point strictly inside the active
  geom, hence contact-free). The static "target" display body's geoms are
  made non-collidable: the reference's hologram target floats 20 cm above
  the workspace and only its orientation matters to the task.

  ``condim``: 4 for Geometries8/100 (the XML default), 3 for the In/Out-
  of-Distribution test envs (their reset writes geom_condim=3).
  """
  hand_dir = _ensure_shadow()
  out_path = os.path.join(hand_dir, f"myohand_sar_tpu_condim{condim}.xml")
  if os.path.exists(out_path):
    return out_path
  src = os.path.join(ASSET_ROOT, "envs/myo/assets/hand/myohand_sar.xml")
  with open(src) as f:
    xml = f.read()
  obj_line = ('<geom name="obj" type="ellipsoid" size="0.015 0.015 0.045" '
              'condim="4" rgba=".6 .6 .6 .6" density="1500"/>')
  assert obj_line in xml, "reference myohand_sar.xml layout changed"
  multi = "\n            ".join([
      f'<geom name="obj_caps" type="capsule" size="0.015 0.035" '
      f'condim="{condim}" rgba=".6 .6 .6 .6" density="1500"/>',
      f'<geom name="obj_ellip" type="ellipsoid" size="0.015 0.015 0.045" '
      f'condim="{condim}" rgba=".6 .6 .6 .6" density="1"/>',
      f'<geom name="obj_cyl" type="cylinder" size="0.015 0.035" '
      f'condim="{condim}" rgba=".6 .6 .6 .6" density="1"/>',
      f'<geom name="obj_box" type="box" size="0.017 0.017 0.017" '
      f'condim="{condim}" rgba=".6 .6 .6 .6" density="1"/>',
  ])
  xml = xml.replace(obj_line, multi)
  tgt_line = ('<geom name="target" type="ellipsoid" size="0.015 0.015 '
              '0.045" condim="4" rgba=".6 .6 .6 .6" />')
  assert tgt_line in xml, "reference myohand_sar.xml target layout changed"
  xml = xml.replace(tgt_line, tgt_line.replace(
      'condim="4"', 'condim="4" contype="0" conaffinity="0"'))
  with open(out_path, "w") as f:
    f.write(xml)
  return out_path
