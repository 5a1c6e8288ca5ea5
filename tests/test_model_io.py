"""engine.model save/load and the committed synthetic scene's files."""
import dataclasses

import numpy as np
import pytest

from myosuite_mjx_tpu.engine import model as emodel
from myosuite_mjx_tpu.models import synthetic
from myosuite_mjx_tpu.models.synthetic import build

# a model with mesh hulls, an equality, a sensor and a keyframe, so every
# kind of Model field goes through the file
MESH_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/>
  </asset>
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body name="a" pos="0 0 0.3">
      <freejoint/>
      <geom name="m" type="mesh" mesh="tet"/>
    </body>
    <body name="b" pos="0.3 0 0.3">
      <joint name="h" type="hinge" range="-1 1"/>
      <geom type="capsule" size="0.02 0.05"/>
      <site name="s"/>
    </body>
  </worldbody>
  <equality><joint joint1="h" polycoef="0.1 0 0 0 0"/></equality>
  <sensor><jointpos joint="h"/></sensor>
  <keyframe><key qpos="0 0 0.3 1 0 0 0 0.2"/></keyframe>
</mujoco>
"""


def assert_models_equal(a, b):
  for f in dataclasses.fields(a):
    va, vb = getattr(a, f.name), getattr(b, f.name)
    if isinstance(va, np.ndarray):
      assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
      np.testing.assert_array_equal(va, vb, err_msg=f.name)
    elif isinstance(va, dict) and va and isinstance(
        next(iter(va.values())), np.ndarray):
      assert sorted(va) == sorted(vb), f.name
      for k in va:
        np.testing.assert_array_equal(va[k], vb[k], err_msg=f.name)
    elif isinstance(va, emodel.Option):
      for g in dataclasses.fields(va):
        np.testing.assert_array_equal(getattr(va, g.name),
                                      getattr(vb, g.name), err_msg=g.name)
    else:
      assert va == vb, f.name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_save_load_round_trip(tmp_path, dtype):
  m = emodel.from_mj(emodel.load_mj_model(MESH_XML), dtype=dtype)
  assert m.mesh_hull_tris and m.neq == 1 and m.nsensor == 1
  path = str(tmp_path / "m.npz")
  emodel.save_model(m, path)
  assert_models_equal(emodel.load_model(path, dtype=dtype), m)


def test_load_casts_floats_to_requested_dtype(tmp_path):
  m = emodel.from_mj(emodel.load_mj_model(MESH_XML))
  path = str(tmp_path / "m.npz")
  emodel.save_model(m, path)
  m32 = emodel.load_model(path, dtype=np.float32)
  assert m32.body_mass.dtype == np.float32
  assert m32.jnt_type.dtype == np.int32 and m32.jnt_limited.dtype == bool
  np.testing.assert_allclose(m32.body_mass, m.body_mass, rtol=1e-7)


def test_committed_npz_equals_fresh_compile_of_committed_xml():
  fresh = emodel.from_mj(emodel.load_mj_model(synthetic.XML_PATH))
  assert_models_equal(emodel.load_model(synthetic.NPZ_PATH), fresh)


def test_committed_xml_is_the_generator_output():
  with open(synthetic.XML_PATH) as f:
    assert f.read() == build.scene_xml()


def test_synthetic_scene_widths():
  m = emodel.load_model(synthetic.NPZ_PATH)
  assert (m.nq, m.nv, m.nu, m.na, m.ntendon) == (30, 29, 39, 39, 39)
  hinge = m.jnt_type == emodel.JointType.HINGE
  assert hinge.sum() == 23 and m.jnt_limited[hinge].all()
  assert (m.actuator_dyntype == emodel.DynType.MUSCLE).all()
  assert (m.actuator_gaintype == emodel.GainType.MUSCLE).all()
  wrapped = {int(np.searchsorted(m.tendon_adr, i, side="right")) - 1
             for i in np.where(np.isin(m.wrap_type, (
                 emodel.WrapType.SPHERE, emodel.WrapType.CYLINDER)))[0]}
  assert len(wrapped) >= 13
  sites = [int(np.sum(m.wrap_type[a:a + n] == emodel.WrapType.SITE))
           for a, n in zip(m.tendon_adr, m.tendon_num)]
  assert min(sites) >= 3 and max(sites) <= 5
  assert m.opt.timestep == 0.002 and m.opt.solver_iterations == 100
  assert m.opt.ls_iterations == 50
