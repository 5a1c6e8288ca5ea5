"""myobase task registrations (SURVEY.md layer 5).

IDs/kwargs mirror the reference registry
(/root/reference/myosuite/envs/myo/myobase/__init__.py) so users can switch
by name. Growing set — pose family first (finger/elbow/hand), then reach,
key-turn, object-hold, pen, walk.
"""
from __future__ import annotations

from myosuite_mjx_tpu.envs.pose import PoseEnv
from myosuite_mjx_tpu.envs.registry import asset, register

# ---- Finger ----------------------------------------------------------------

register(
    "myoFingerPoseFixed-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/myofinger_v0.xml"),
        target_jnt_range={
            "IFadb": (0, 0),
            "IFmcp": (0, 0),
            "IFpip": (0.75, 0.75),
            "IFdip": (0.75, 0.75),
        },
        normalize_act=True,
    ))

register(
    "myoFingerPoseRandom-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/myofinger_v0.xml"),
        target_jnt_range={
            "IFadb": (-0.2, 0.2),
            "IFmcp": (-0.4, 1),
            "IFpip": (0.1, 1),
            "IFdip": (0.1, 1),
        },
        normalize_act=True,
    ))

register(
    "motorFingerPoseFixed-v0", PoseEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/motorfinger_v0.xml"),
        target_jnt_range={
            "IFadb": (0, 0),
            "IFmcp": (0, 0),
            "IFpip": (0.75, 0.75),
            "IFdip": (0.75, 0.75),
        },
        normalize_act=True,
        frame_skip=5,
    ))

register(
    "motorFingerPoseRandom-v0", PoseEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/motorfinger_v0.xml"),
        target_jnt_range={
            "IFadb": (-0.2, 0.2),
            "IFmcp": (-0.4, 1),
            "IFpip": (0.1, 1),
            "IFdip": (0.1, 1),
        },
        normalize_act=True,
        frame_skip=5,
    ))

# ---- Elbow -----------------------------------------------------------------

register(
    "myoElbowPose1D6MFixed-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset(
            "simhive/myo_sim/elbow/myoelbow_1dof6muscles.xml"),
        target_jnt_range={"r_elbow_flex": (2, 2)},
        normalize_act=True,
        pose_thd=0.175,
        reset_type="random",
    ))

register(
    "myoElbowPose1D6MRandom-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset(
            "simhive/myo_sim/elbow/myoelbow_1dof6muscles.xml"),
        target_jnt_range={"r_elbow_flex": (0, 2.27)},
        normalize_act=True,
        pose_thd=0.175,
        reset_type="random",
    ))

# ---- Hand ------------------------------------------------------------------

_HAND_POSE_XML = asset("envs/myo/assets/hand/myohand_pose.xml")

_HAND_JNT_NAMES = [
    "pro_sup", "deviation", "flexion", "cmc_abduction", "cmc_flexion",
    "mp_flexion", "ip_flexion", "mcp2_flexion", "mcp2_abduction",
    "pm2_flexion", "md2_flexion", "mcp3_flexion", "mcp3_abduction",
    "pm3_flexion", "md3_flexion", "mcp4_flexion", "mcp4_abduction",
    "pm4_flexion", "md4_flexion", "mcp5_flexion", "mcp5_abduction",
    "pm5_flexion", "md5_flexion",
]

# ASL numeral hand poses (task data mirrored from the reference registry,
# envs/myo/myobase/__init__.py:300-414)
_ASL_QPOS = [
    "0 0 0 0.5624 0.28272 -0.75573 -1.309 1.30045 -0.006982 1.45492 0.998897 1.26466 0 1.40604 0.227795 1.07614 -0.020944 1.46103 0.06284 0.83263 -0.14399 1.571 1.38248",
    "0 0 0 0.0248 0.04536 -0.7854 -1.309 0.366605 0.010473 0.269258 0.111722 1.48459 0 1.45318 1.44532 1.44532 -0.204204 1.46103 1.44532 1.48459 -0.2618 1.47674 1.48459",
    "0 0 0 0.0248 0.04536 -0.7854 -1.13447 0.514973 0.010473 0.128305 0.111722 0.510575 0 0.37704 0.117825 1.44532 -0.204204 1.46103 1.44532 1.48459 -0.2618 1.47674 1.48459",
    "0 0 0 0.3384 0.25305 0.01569 -0.0262045 0.645885 0.010473 0.128305 0.111722 0.510575 0 0.37704 0.117825 1.571 -0.036652 1.52387 1.45318 1.40604 -0.068068 1.39033 1.571",
    "0 0 0 0.6392 -0.147495 -0.7854 -1.309 0.637158 0.010473 0.128305 0.111722 0.510575 0 0.37704 0.117825 0.306345 -0.010472 0.400605 0.133535 0.21994 -0.068068 0.274925 0.01571",
    "0 0 0 0.3384 0.25305 0.01569 -0.0262045 0.645885 0.010473 0.128305 0.111722 0.510575 0 0.37704 0.117825 0.306345 -0.010472 0.400605 0.133535 0.21994 -0.068068 0.274925 0.01571",
    "0 0 0 0.6392 -0.147495 -0.7854 -1.309 0.637158 0.010473 0.128305 0.111722 0.510575 0 0.37704 0.117825 0.306345 -0.010472 0.400605 0.133535 1.1861 -0.2618 1.35891 1.48459",
    "0 0 0 0.524 0.01569 -0.7854 -1.309 0.645885 -0.006982 0.128305 0.111722 0.510575 0 0.37704 0.117825 1.28036 -0.115192 1.52387 1.45318 0.432025 -0.068068 0.18852 0.149245",
    "0 0 0 0.428 0.22338 -0.7854 -1.309 0.645885 -0.006982 0.128305 0.194636 1.39033 0 1.08399 0.573415 0.667675 -0.020944 0 0.06284 0.432025 -0.068068 0.18852 0.149245",
    "0 0 0 0.5624 0.28272 -0.75573 -1.309 1.30045 -0.006982 1.45492 0.998897 0.39275 0 0.18852 0.227795 0.667675 -0.020944 0 0.06284 0.432025 -0.068068 0.18852 0.149245",
]
_ASL_QPOS = [[float(x) for x in row.split()] for row in _ASL_QPOS]

register(
    "myoHandPoseFixed-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=_HAND_POSE_XML,
        target_jnt_value=[
            0, 0, 0, -0.0904, 0.0824475, -0.681555, -0.514888, 0,
            -0.013964, -0.0458132, 0, 0.67553, -0.020944, 0.76979,
            0.65982, 0, 0, 0, 0, 0.479155, -0.099484, 0.95831, 0,
        ],
        normalize_act=True,
        pose_thd=0.7,
        reset_type="init",
        target_type="fixed",
    ))

for _k, _pose in enumerate(_ASL_QPOS):
  register(
      f"myoHandPose{_k}Fixed-v0", PoseEnv, max_episode_steps=100,
      kwargs=dict(
          model_path=_HAND_POSE_XML,
          target_jnt_value=_pose,
          normalize_act=True,
          pose_thd=0.7,
          reset_type="init",
          target_type="fixed",
      ))

_asl = list(zip(*_ASL_QPOS))
_HAND_POSE_RANGES = {
    n: (min(_asl[i]), max(_asl[i])) for i, n in enumerate(_HAND_JNT_NAMES)}

register(
    "myoHandPoseRandom-v0", PoseEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=_HAND_POSE_XML,
        target_jnt_range=_HAND_POSE_RANGES,
        normalize_act=True,
        pose_thd=0.7,
        reset_type="random",
    ))

# ---- Reach -----------------------------------------------------------------

from myosuite_mjx_tpu.envs.reach import ReachEnv  # noqa: E402

register(
    "myoFingerReachFixed-v0", ReachEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/myofinger_v0.xml"),
        target_reach_range={"IFtip": ((0.2, 0.05, 0.20), (0.2, 0.05, 0.20))},
        normalize_act=True,
    ))

register(
    "myoFingerReachRandom-v0", ReachEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/myofinger_v0.xml"),
        target_reach_range={"IFtip": ((0.1, -0.1, 0.1), (0.27, 0.1, 0.3))},
        normalize_act=True,
    ))

register(
    "motorFingerReachFixed-v0", ReachEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/motorfinger_v0.xml"),
        target_reach_range={"IFtip": ((0.2, 0.05, 0.20), (0.2, 0.05, 0.20))},
        normalize_act=True,
        frame_skip=5,
    ))

register(
    "motorFingerReachRandom-v0", ReachEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/finger/motorfinger_v0.xml"),
        target_reach_range={"IFtip": ((0.1, -0.1, 0.1), (0.27, 0.1, 0.3))},
        normalize_act=True,
        frame_skip=5,
    ))

register(
    "myoHandReachFixed-v0", ReachEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_pose.xml"),
        target_reach_range={
            "THtip": ((-0.165, -0.537, 1.495), (-0.165, -0.537, 1.495)),
            "IFtip": ((-0.151, -0.547, 1.455), (-0.151, -0.547, 1.455)),
            "MFtip": ((-0.146, -0.547, 1.447), (-0.146, -0.547, 1.447)),
            "RFtip": ((-0.148, -0.543, 1.445), (-0.148, -0.543, 1.445)),
            "LFtip": ((-0.148, -0.528, 1.434), (-0.148, -0.528, 1.434)),
        },
        normalize_act=True,
        far_th=0.044,
    ))

register(
    "myoHandReachRandom-v0", ReachEnv, max_episode_steps=100,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_pose.xml"),
        target_reach_range={
            "THtip": ((-0.185, -0.577, 1.455), (-0.125, -0.517, 1.535)),
            "IFtip": ((-0.191, -0.567, 1.445), (-0.111, -0.527, 1.465)),
            "MFtip": ((-0.186, -0.567, 1.437), (-0.106, -0.527, 1.457)),
            "RFtip": ((-0.188, -0.563, 1.435), (-0.108, -0.523, 1.455)),
            "LFtip": ((-0.188, -0.548, 1.424), (-0.108, -0.508, 1.444)),
        },
        normalize_act=True,
        far_th=0.034,
    ))

# ---- Object hold -----------------------------------------------------------

from myosuite_mjx_tpu.envs.obj_hold import ObjHoldEnv, ObjHoldRandomEnv  # noqa: E402

register(
    "myoHandObjHoldFixed-v0", ObjHoldEnv, max_episode_steps=75,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_hold.xml"),
        normalize_act=True,
    ))

register(
    "myoHandObjHoldRandom-v0", ObjHoldRandomEnv, max_episode_steps=75,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_hold.xml"),
        normalize_act=True,
    ))

# ---- Key turn / Pen twirl --------------------------------------------------

import numpy as _np  # noqa: E402
from myosuite_mjx_tpu.envs.key_turn import KeyTurnEnv  # noqa: E402
from myosuite_mjx_tpu.envs.pen import (  # noqa: E402
    PenTwirlFixedEnv, PenTwirlRandomEnv)

register(
    "myoHandKeyTurnFixed-v0", KeyTurnEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_keyturn.xml"),
        normalize_act=True,
    ))

register(
    "myoHandKeyTurnRandom-v0", KeyTurnEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_keyturn.xml"),
        normalize_act=True,
        key_init_range=(-_np.pi / 2, _np.pi / 2),
        goal_th=2 * _np.pi,
    ))

register(
    "myoHandPenTwirlFixed-v0", PenTwirlFixedEnv, max_episode_steps=50,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_pen.xml"),
        normalize_act=True,
        frame_skip=5,
    ))

register(
    "myoHandPenTwirlRandom-v0", PenTwirlRandomEnv, max_episode_steps=50,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_pen.xml"),
        normalize_act=True,
        frame_skip=5,
    ))

# ---- SAR reorient family (myobase/__init__.py:638-686) ---------------------

from myosuite_mjx_tpu.envs.reorient_sar import (  # noqa: E402
    Geometries8Env, Geometries100Env, InDistributionEnv,
    OutOfDistributionEnv)
from myosuite_mjx_tpu.models.assets import sar_scene_xml  # noqa: E402
import functools as _functools  # noqa: E402

for _id, _cls, _condim in [
    ("myoHandReorient8-v0", Geometries8Env, 4),
    ("myoHandReorient100-v0", Geometries100Env, 4),
    ("myoHandReorientID-v0", InDistributionEnv, 3),
    ("myoHandReorientOOD-v0", OutOfDistributionEnv, 3),
]:
  register(
      _id, _cls, max_episode_steps=50,
      kwargs=dict(
          model_path=_functools.partial(sar_scene_xml, condim=_condim),
          normalize_act=True,
          frame_skip=5,
      ))

# ---- muscle-condition variants (reference scheme, myobase/__init__.py:16-48)

from myosuite_mjx_tpu.envs.registry import (  # noqa: E402
    register_env_variant, registry_ids)

for _id in list(registry_ids()):
  if _id.startswith("myo"):
    register_env_variant(
        _id, "myoSarc" + _id[3:], {"muscle_condition": "sarcopenia"})
    register_env_variant(
        _id, "myoFati" + _id[3:], {"muscle_condition": "fatigue"})
  if _id.startswith("myoHand"):
    register_env_variant(
        _id, "myoReaf" + _id[3:], {"muscle_condition": "reafferentation"})

# ---- Leg stand/reach -------------------------------------------------------

from myosuite_mjx_tpu.envs.walk import LegReachEnv  # noqa: E402

register(
    "myoLegStandRandom-v0", LegReachEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/leg/myolegs.xml"),
        joint_random_range=(-0.2, 0.2),
        target_reach_range={
            "pelvis": ((-0.05, -0.05, 0), (0.05, 0.05, 0)),
        },
        normalize_act=True,
        far_th=0.44,
    ))

for _id in ["myoLegStandRandom-v0"]:
  register_env_variant(_id, "myoSarc" + _id[3:],
                       {"muscle_condition": "sarcopenia"})
  register_env_variant(_id, "myoFati" + _id[3:],
                       {"muscle_condition": "fatigue"})

from myosuite_mjx_tpu.envs.walk import WalkEnv  # noqa: E402

register(
    "myoLegWalk-v0", WalkEnv, max_episode_steps=1000,
    kwargs=dict(
        model_path=asset("simhive/myo_sim/leg/myolegs.xml"),
        normalize_act=True,
        min_height=0.8,
        max_rot=0.8,
        hip_period=100,
        reset_type="random",
        target_x_vel=0.0,
        target_y_vel=1.2,
    ))
for _id in ["myoLegWalk-v0"]:
  register_env_variant(_id, "myoSarc" + _id[3:],
                       {"muscle_condition": "sarcopenia"})
  register_env_variant(_id, "myoFati" + _id[3:],
                       {"muscle_condition": "fatigue"})

from myosuite_mjx_tpu.envs.walk import TerrainWalkEnv  # noqa: E402

for _tid, _terrain, _variant in [
    ("myoLegRoughTerrainWalk-v0", "rough", None),
    ("myoLegHillyTerrainWalk-v0", "hilly", "fixed"),
    ("myoLegStairTerrainWalk-v0", "stairs", "fixed"),
]:
  register(
      _tid, TerrainWalkEnv, max_episode_steps=1000,
      kwargs=dict(
          model_path=asset("simhive/myo_sim/leg/myolegs.xml"),
          normalize_act=True,
          min_height=0.8,
          max_rot=0.8,
          hip_period=100,
          reset_type="random",
          target_x_vel=0.0,
          target_y_vel=1.2,
          terrain=_terrain,
          variant=_variant,
      ))
  register_env_variant(_tid, "myoSarc" + _tid[3:],
                       {"muscle_condition": "sarcopenia"})
  register_env_variant(_tid, "myoFati" + _tid[3:],
                       {"muscle_condition": "fatigue"})

# ---- visual-obs variant (reference env_base.py:419-510 visual_keys) --------
# One registered rgb task: proprioceptive obs from the jitted step plus
# host-rendered rgb features via env.get_visuals / env.obs_with_visuals.
register_env_variant(
    "myoFingerPoseFixed-v0", "myoFingerPoseFixedRGB-v0",
    {"visual_keys": ["rgb:free:32x32:1d", "rgb:free:32x32:cnn"]})
