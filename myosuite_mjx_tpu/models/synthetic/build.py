"""Generate the synthetic musculoskeletal hand scene and its compiled Model.

SYNTHETIC: this is not MyoSuite's myoHand and no number taken on it is a
myoHand number. It exists so the engine, envs and trainers can be built,
tested and run from committed files alone, at myoHand's published widths
and through the code paths myoHand exercises:

* 23 limited hinge joints named and ordered like myoHand's pose joints
  (forearm pronation, wrist deviation/flexion, a 4-joint thumb, four
  4-joint fingers);
* 39 muscle actuators (``dyntype=muscle``, FLV gain and bias), each on a
  spatial tendon of 3-5 sites; 20 of them wrap a sphere or a cylinder
  chosen by a side site;
* capsule palm and finger geoms, one free sphere resting in the palm and
  a floor, so contacts are active from the first step (nq 30, nv 29);
* myoHand's timestep and solver: 2 ms, Newton, 100 iterations, 50 line
  search iterations.

Run from the checkout root to rewrite both files after editing this one:

    python -m myosuite_mjx_tpu.models.synthetic.build

The XML is the source; the ``.npz`` is compiled from the written XML by
MuJoCo's compiler and ``engine.model.save_model``, and loads without
``mujoco``.
"""
from __future__ import annotations

from myosuite_mjx_tpu.models.synthetic import NAME, NPZ_PATH, XML_PATH

# finger rays 2..5 (index..little): palm-frame y of each ray
_RAYS = {2: -0.03, 3: -0.01, 4: 0.01, 5: 0.03}


def _f(v) -> str:
  return " ".join(f"{x:g}" for x in v)


class _Scene:
  """Collects sites and wrap geoms per body, and the muscle paths."""

  def __init__(self):
    self.sites: dict[str, list[str]] = {}
    self.wraps: dict[str, list[str]] = {}
    self.tendons: list[str] = []
    self.muscles: list[str] = []

  def site(self, body: str, name: str, pos) -> str:
    self.sites.setdefault(body, []).append(
        f'<site name="{name}" pos="{_f(pos)}" size="0.002"/>')
    return name

  def wrap(self, body: str, name: str, kind: str, pos, size,
           zaxis=None) -> str:
    ax = f' zaxis="{_f(zaxis)}"' if zaxis is not None else ""
    sz = f"{size:g}" if kind == "sphere" else f"{size:g} 0.01"
    self.wraps.setdefault(body, []).append(
        f'<geom name="{name}" class="wrap" type="{kind}" pos="{_f(pos)}" '
        f'size="{sz}"{ax}/>')
    return name

  def muscle(self, name: str, force: float, path) -> None:
    """path: ('site', body, pos) | ('wrap', geom, (body, sidesite pos))."""
    elems, nsite = [], 0
    for k, item in enumerate(path):
      if item[0] == "site":
        _, body, pos = item
        elems.append(f'<site site="{self.site(body, f"{name}_s{k}", pos)}"/>')
        nsite += 1
      else:
        _, geom, (body, side) = item
        ss = self.site(body, f"{name}_side", side)
        elems.append(f'<geom geom="{geom}" sidesite="{ss}"/>')
    assert 3 <= nsite <= 5, (name, nsite)
    self.tendons.append(
        f'<spatial name="{name}_tendon">' + "".join(elems) + "</spatial>")
    self.muscles.append(
        f'<muscle name="{name}" tendon="{name}_tendon" force="{force:g}"/>')

  def body_extras(self, body: str, indent: str) -> str:
    lines = self.wraps.get(body, []) + self.sites.get(body, [])
    return "".join(f"\n{indent}{x}" for x in lines)


def _muscles(s: _Scene) -> None:
  S, W = "site", "wrap"
  # wrap geoms: a sphere at the wrist, a cylinder along the forearm, one
  # cylinder per MCP joint and thumb MP joint, a sphere per PIP joint
  s.wrap("carpal", "wrist_wrap", "sphere", (0, 0, 0), 0.012)
  s.wrap("radius", "radius_wrap", "cylinder", (-0.01, 0, 0), 0.01,
         zaxis=(1, 0, 0))
  s.wrap("thumb_mc", "thumb_mp_wrap", "cylinder", (0.035, 0, 0), 0.006,
         zaxis=(0, 1, 0))
  for i, y in _RAYS.items():
    s.wrap("carpal", f"mcp{i}_wrap", "cylinder", (0.095, y, 0), 0.007,
           zaxis=(0, 1, 0))
    s.wrap(f"mid{i}", f"pip{i}_wrap", "sphere", (0, 0, 0), 0.006)

  palmar_wrist = ("carpal", (0, 0, 0.02))
  dorsal_wrist = ("carpal", (0, 0, -0.02))
  # wrist and forearm (9)
  s.muscle("FCR", 60, [(S, "forearm", (-0.15, -0.01, 0.015)),
                       (S, "forearm", (-0.05, -0.01, 0.016)),
                       (W, "wrist_wrap", palmar_wrist),
                       (S, "carpal", (0.03, -0.01, 0.012))])
  s.muscle("FCU", 60, [(S, "forearm", (-0.15, 0.012, 0.014)),
                       (S, "forearm", (-0.04, 0.014, 0.016)),
                       (W, "wrist_wrap", palmar_wrist),
                       (S, "carpal", (0.03, 0.02, 0.012))])
  s.muscle("PL", 30, [(S, "forearm", (-0.14, 0, 0.018)),
                      (S, "carpal", (0.01, 0, 0.015)),
                      (S, "carpal", (0.05, 0, 0.012))])
  s.muscle("ECRL", 60, [(S, "forearm", (-0.15, -0.012, -0.015)),
                        (S, "forearm", (-0.04, -0.014, -0.016)),
                        (W, "wrist_wrap", dorsal_wrist),
                        (S, "carpal", (0.03, -0.02, -0.012))])
  s.muscle("ECRB", 60, [(S, "forearm", (-0.14, -0.004, -0.016)),
                        (S, "carpal", (0.01, -0.006, -0.014)),
                        (S, "carpal", (0.04, -0.008, -0.012))])
  s.muscle("ECU", 60, [(S, "forearm", (-0.15, 0.014, -0.014)),
                       (S, "forearm", (-0.04, 0.016, -0.015)),
                       (W, "wrist_wrap", dorsal_wrist),
                       (S, "carpal", (0.03, 0.022, -0.012))])
  s.muscle("PT", 40, [(S, "forearm", (-0.16, 0.018, 0.008)),
                      (S, "forearm", (-0.08, 0.012, 0.01)),
                      (W, "radius_wrap", ("radius", (-0.01, 0, 0.02))),
                      (S, "radius", (-0.012, -0.017, 0.01))])
  s.muscle("SUP", 40, [(S, "forearm", (-0.16, -0.018, -0.008)),
                       (S, "forearm", (-0.08, -0.012, -0.01)),
                       (W, "radius_wrap", ("radius", (-0.01, 0, -0.02))),
                       (S, "radius", (-0.006, 0.018, -0.006))])
  s.muscle("BRD", 40, [(S, "forearm", (-0.18, 0, -0.02)),
                       (S, "forearm", (-0.06, -0.015, -0.01)),
                       (S, "radius", (-0.004, -0.02, 0))])
  # thumb (6)
  s.muscle("FPL", 30, [(S, "forearm", (-0.14, -0.012, 0.012)),
                       (S, "carpal", (0.015, -0.025, 0.01)),
                       (S, "thumb_mc", (0.02, 0, 0.011)),
                       (W, "thumb_mp_wrap", ("thumb_mc", (0.035, 0, 0.014))),
                       (S, "thumb_pp", (0.015, 0, 0.01)),
                       (S, "thumb_dp", (0.012, 0, 0.008))])
  s.muscle("EPL", 30, [(S, "forearm", (-0.14, -0.01, -0.012)),
                       (S, "carpal", (0.015, -0.025, -0.011)),
                       (S, "thumb_mc", (0.02, 0, -0.011)),
                       (W, "thumb_mp_wrap",
                        ("thumb_mc", (0.035, 0, -0.014))),
                       (S, "thumb_pp", (0.015, 0, -0.01)),
                       (S, "thumb_dp", (0.012, 0, -0.008))])
  s.muscle("APL", 20, [(S, "forearm", (-0.12, -0.016, 0)),
                       (S, "carpal", (0.01, -0.03, -0.004)),
                       (S, "thumb_mc", (0.01, -0.01, 0))])
  s.muscle("OP", 15, [(S, "carpal", (0.03, -0.01, 0.012)),
                      (S, "carpal", (0.025, -0.03, 0.012)),
                      (S, "thumb_mc", (0.025, 0.006, 0.008))])
  s.muscle("FPB", 15, [(S, "carpal", (0.035, -0.015, 0.012)),
                       (S, "thumb_mc", (0.03, 0.004, 0.01)),
                       (S, "thumb_pp", (0.008, 0, 0.01))])
  s.muscle("ADP", 15, [(S, "carpal", (0.06, -0.01, 0.011)),
                       (S, "carpal", (0.04, -0.03, 0.011)),
                       (S, "thumb_pp", (0.006, 0.008, 0.006))])
  # fingers (4 x 6)
  for i, y in _RAYS.items():
    yf = 0.5 * y
    s.muscle(f"FDP{i}", 30, [(S, "forearm", (-0.13, yf, 0.014)),
                             (S, "carpal", (0.08, y, 0.012)),
                             (W, f"mcp{i}_wrap",
                              ("carpal", (0.095, y, 0.015))),
                             (S, f"prox{i}", (0.02, 0, 0.01)),
                             (S, f"mid{i}", (0.012, 0, 0.009)),
                             (S, f"dist{i}", (0.01, 0, 0.007))])
    s.muscle(f"FDS{i}", 30, [(S, "forearm", (-0.12, yf, 0.013)),
                             (S, "carpal", (0.08, y, 0.011)),
                             (S, f"prox{i}", (0.03, 0, 0.009)),
                             (W, f"pip{i}_wrap",
                              (f"mid{i}", (0, 0, 0.014))),
                             (S, f"mid{i}", (0.01, 0, 0.008))])
    s.muscle(f"EDC{i}", 30, [(S, "forearm", (-0.13, yf, -0.014)),
                             (S, "carpal", (0.08, y, -0.012)),
                             (W, f"mcp{i}_wrap",
                              ("carpal", (0.095, y, -0.015))),
                             (S, f"prox{i}", (0.02, 0, -0.01)),
                             (S, f"mid{i}", (0.01, 0, -0.008))])
    s.muscle(f"DI{i}", 10, [(S, "carpal", (0.05, y - 0.008, -0.004)),
                            (S, "carpal", (0.085, y - 0.009, -0.003)),
                            (S, f"prox{i}", (0.012, -0.007, -0.002))])
    s.muscle(f"PI{i}", 10, [(S, "carpal", (0.05, y + 0.008, 0.004)),
                            (S, "carpal", (0.085, y + 0.009, 0.005)),
                            (S, f"prox{i}", (0.012, 0.007, 0.004))])
    s.muscle(f"LU{i}", 5, [(S, "carpal", (0.06, y, 0.013)),
                           (S, f"prox{i}", (0.015, 0.004, 0.008)),
                           (S, f"mid{i}", (0.008, 0, 0.006))])


def scene_xml() -> str:
  s = _Scene()
  _muscles(s)
  assert len(s.muscles) == 39

  def cap(length, r, name):
    return (f'<geom name="{name}" type="capsule" '
            f'fromto="0 0 0 {length:g} 0 0" size="{r:g}"/>')

  fingers = ""
  for i, y in _RAYS.items():
    fingers += f"""
          <body name="prox{i}" pos="0.095 {y:g} 0">
            <joint name="mcp{i}_flexion" axis="0 -1 0" range="-0.3 1.6"/>
            <joint name="mcp{i}_abduction" axis="0 0 1" range="-0.3 0.3"/>
            {cap(0.04, 0.008, f"prox{i}_geom")}{s.body_extras(f"prox{i}", " " * 12)}
            <body name="mid{i}" pos="0.04 0 0">
              <joint name="pm{i}_flexion" axis="0 -1 0" range="0 1.8"/>
              {cap(0.025, 0.007, f"mid{i}_geom")}{s.body_extras(f"mid{i}", " " * 14)}
              <body name="dist{i}" pos="0.025 0 0">
                <joint name="md{i}_flexion" axis="0 -1 0" range="0 1.5"/>
                {cap(0.02, 0.006, f"dist{i}_geom")}{s.body_extras(f"dist{i}", " " * 16)}
              </body>
            </body>
          </body>"""
  palm = "".join(
      f'\n          <geom name="palm{k}" type="capsule" '
      f'fromto="0.02 {y:g} 0 0.085 {y:g} 0" size="0.01"/>'
      for k, y in enumerate(_RAYS.values()))
  tendons = "".join(f"\n    {t}" for t in s.tendons)
  muscles = "".join(f"\n    {m}" for m in s.muscles)
  return f"""<!-- SYNTHETIC scene, not MyoSuite's myoHand. Written by
     myosuite_mjx_tpu/models/synthetic/build.py; edit that file, not this. -->
<mujoco model="{NAME}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" solver="Newton" iterations="100"
          ls_iterations="50"/>
  <default>
    <joint type="hinge" damping="0.05" armature="0.001"/>
    <geom condim="3" friction="1 0.005 0.0001" density="1000"/>
    <muscle ctrllimited="true" ctrlrange="0 1"/>
    <default class="wrap">
      <geom contype="0" conaffinity="0" density="0" group="3"/>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.01"/>
    <body name="forearm" pos="0 0 0.1">
      <geom name="forearm_geom" type="capsule" fromto="-0.2 0 0 -0.05 0 0"
            size="0.02"/>{s.body_extras("forearm", " " * 6)}
      <body name="radius" pos="0 0 0">
        <joint name="pro_sup" axis="1 0 0" range="-1.2 1.2"/>
        <geom name="radius_geom" type="capsule" fromto="-0.015 0 0 0 0 0"
              size="0.012"/>{s.body_extras("radius", " " * 8)}
        <body name="carpal" pos="0.005 0 0">
          <joint name="deviation" axis="0 0 1" range="-0.3 0.5"/>
          <joint name="flexion" axis="0 -1 0" range="-1 1"/>{palm}{s.body_extras("carpal", " " * 10)}
          <body name="thumb_mc" pos="0.02 -0.04 0" euler="0 0 -0.7">
            <joint name="cmc_abduction" axis="0 0 1" range="-0.6 0.6"/>
            <joint name="cmc_flexion" axis="0 -1 0" range="-0.5 1.2"/>
            {cap(0.035, 0.01, "thumb_mc_geom")}{s.body_extras("thumb_mc", " " * 12)}
            <body name="thumb_pp" pos="0.035 0 0">
              <joint name="mp_flexion" axis="0 -1 0" range="-0.3 1.2"/>
              {cap(0.03, 0.009, "thumb_pp_geom")}{s.body_extras("thumb_pp", " " * 14)}
              <body name="thumb_dp" pos="0.03 0 0">
                <joint name="ip_flexion" axis="0 -1 0" range="-0.3 1.4"/>
                {cap(0.022, 0.008, "thumb_dp_geom")}{s.body_extras("thumb_dp", " " * 16)}
              </body>
            </body>
          </body>{fingers}
        </body>
      </body>
    </body>
    <body name="object" pos="0.06 0 0.128">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="sphere" size="0.02" density="500"/>
    </body>
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <actuator>{muscles}
  </actuator>
</mujoco>
"""


def build() -> None:
  import numpy as np

  from myosuite_mjx_tpu.engine import model as model_mod
  with open(XML_PATH, "w") as f:
    f.write(scene_xml())
  mj = model_mod.load_mj_model(XML_PATH)
  model_mod.save_model(model_mod.from_mj(mj, dtype=np.float64), NPZ_PATH)


if __name__ == "__main__":
  build()
