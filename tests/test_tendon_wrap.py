"""Side-site wraps against CPU MuJoCo on a one-tendon scene: a fixed site,
a wrap geom at the origin with a side site, and a site on a body hinged
about the geom's axis. float64 (conftest)."""
import mujoco
import numpy as np
import pytest

from myosuite_mjx_tpu.engine import model as emodel
from myosuite_mjx_tpu.engine import smooth, tendon

R = 0.01


def _scene(geom_type, side, a, b=(0.05, 0.015, 0.0)):
  size = f"{R} 0.02" if geom_type == "cylinder" else f"{R}"
  f = lambda v: " ".join(map(str, v))
  return f"""<mujoco><worldbody>
  <geom name="w" type="{geom_type}" size="{size}" contype="0" conaffinity="0"/>
  <site name="a" pos="{f(a)}"/><site name="s" pos="{f(side)}"/>
  <body name="b"><joint name="h" type="hinge" axis="0 0 1" range="-3 3"/>
    <geom type="sphere" size="0.005" pos="0.06 0 0" mass="0.01"/>
    <site name="b" pos="{f(b)}"/></body></worldbody>
  <tendon><spatial name="t"><site site="a"/><geom geom="w" sidesite="s"/>
    <site site="b"/></spatial></tendon></mujoco>"""


def _lengths(xml, angles):
  """(engine, MuJoCo) tendon length and MuJoCo's wrap count per angle."""
  mj = mujoco.MjModel.from_xml_string(xml)
  d = mujoco.MjData(mj)
  m = emodel.from_mj(mj)
  out = []
  for q in angles:
    d.qpos[:] = q
    mujoco.mj_forward(mj, d)
    kin = smooth.kinematics(m, np.array([q]), np.zeros((0, 3)),
                            np.zeros((0, 4)))
    _, _, cdof = smooth.com_pos(m, kin)
    length, _ = tendon.tendon(m, kin, cdof)
    out.append((float(length[0]), d.ten_length[0], d.ten_wrapnum[0]))
  return np.array(out)


@pytest.mark.parametrize("geom_type", ["cylinder", "sphere"])
@pytest.mark.parametrize("side_y", [0.02, -0.02])
def test_side_site_wrap_matches_mujoco(geom_type, side_y):
  """A fixed site on the geom's side-site axis: the path wraps on the side
  site's side over the whole hinge range, as MuJoCo's does."""
  got = _lengths(_scene(geom_type, (0, side_y, 0), (-0.05, 0, 0)),
                 np.linspace(-2.5, 2.5, 11))
  assert (got[:, 2] == 4).any()          # some angles wrap
  np.testing.assert_allclose(got[:, 0], got[:, 1], atol=1e-12)


@pytest.mark.parametrize("geom_type", ["cylinder", "sphere"])
def test_far_side_wrap_known_gap(geom_type):
  """KNOWN BUG (ROADMAP §2.1), pinned at its measured size. The straight
  path passes the geom on one side and the side site sits on the other:
  MuJoCo wraps on the side site's side (0.1103 m), the engine takes the
  other tangent pair and goes round the far side, 5.48 cm longer.
  MuJoCo chooses between the two tangent pairs by the chord midpoint's
  direction to the side site and never takes a pair whose tangent lines
  cross; ``tendon.wrap_circle`` compares arc midpoints instead. When the
  wrap is repaired this test fails: make it a parity assertion then."""
  got = _lengths(_scene(geom_type, (0, 0.02, 0), (-0.05, -0.015, 0)),
                 [-0.4])[0]
  assert got[2] == 4
  np.testing.assert_allclose(got[1], 0.110325, atol=1e-6)
  np.testing.assert_allclose(got[0] - got[1], 0.054832, atol=1e-5)
