"""MyoChallenge registrations (Baoding, Die Reorient, Relocate).

IDs/kwargs mirror /root/reference/myosuite/envs/myo/myochallenge/__init__.py.
(ChaseTag and RunTrack/OSL land with the procedural-terrain + opponent
state-machine work.)
"""
from __future__ import annotations

import numpy as np

from myosuite_mjx_tpu.envs.baoding import BaodingEnv
from myosuite_mjx_tpu.envs.registry import asset, register
from myosuite_mjx_tpu.envs.relocate import RelocateEnv
from myosuite_mjx_tpu.envs.reorient import ReorientEnv

register(
    "myoChallengeBaodingP1-v1", BaodingEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_baoding.xml"),
        normalize_act=True,
        goal_time_period=(5, 5),
        goal_xrange=(0.025, 0.025),
        goal_yrange=(0.028, 0.028),
    ))

register(
    "myoChallengeBaodingP2-v1", BaodingEnv, max_episode_steps=200,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_baoding.xml"),
        normalize_act=True,
        goal_time_period=(4, 6),
        goal_xrange=(0.020, 0.030),
        goal_yrange=(0.022, 0.032),
        obj_size_range=(0.018, 0.024),
        obj_mass_range=(0.030, 0.300),
        obj_friction_change=(0.2, 0.001, 0.00002),
        task_choice="random",
    ))

register(
    "myoChallengeDieReorientDemo-v0", ReorientEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_die.xml"),
        normalize_act=True,
        frame_skip=5,
        pos_th=np.inf,
        goal_pos=(0, 0),
        goal_rot=(-0.785, 0.785),
    ))

register(
    "myoChallengeDieReorientP1-v0", ReorientEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_die.xml"),
        normalize_act=True,
        frame_skip=5,
        goal_pos=(-0.010, 0.010),
        goal_rot=(-1.57, 1.57),
    ))

register(
    "myoChallengeDieReorientP2-v0", ReorientEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("envs/myo/assets/hand/myohand_die.xml"),
        normalize_act=True,
        frame_skip=5,
        goal_pos=(-0.020, 0.020),
        goal_rot=(-3.14, 3.14),
    ))

register(
    "myoChallengeRelocateP1-v0", RelocateEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("envs/myo/assets/arm/myoarm_relocate.xml"),
        normalize_act=True,
        frame_skip=5,
        pos_th=0.1,
        rot_th=np.inf,
        target_xyz_range={"high": [0.2, -0.1, 0.9], "low": [0.0, -0.35, 0.9]},
        target_rxryrz_range={"high": [0.0, 0.0, 0.0],
                             "low": [0.0, 0.0, 0.0]},
    ))

register(
    "myoChallengeRelocateP2-v0", RelocateEnv, max_episode_steps=150,
    kwargs=dict(
        model_path=asset("envs/myo/assets/arm/myoarm_relocate.xml"),
        normalize_act=True,
        frame_skip=5,
        pos_th=0.1,
        rot_th=np.inf,
        qpos_noise_range=0.01,
        target_xyz_range={"high": [0.3, -0.1, 1.05],
                          "low": [0.0, -0.45, 0.9]},
        target_rxryrz_range={"high": [0.2, 0.2, 0.2],
                             "low": [-0.2, -0.2, -0.2]},
        obj_xyz_range={"high": [0.1, -0.15, 1.0], "low": [-0.1, -0.35, 1.0]},
    ))

from myosuite_mjx_tpu.envs.chasetag import ChaseTagEnv  # noqa: E402

register(
    "myoChallengeChaseTagP1-v0", ChaseTagEnv, max_episode_steps=2000,
    kwargs=dict(
        model_path=asset("envs/myo/assets/leg/myolegs_chasetag.xml"),
        normalize_act=True,
        win_distance=0.5,
        min_spawn_distance=2,
        reset_type="init",
        terrain="FLAT",
        task_choice="CHASE",
        opponent_probabilities=(0.1, 0.45, 0.45),
    ))

register(
    "myoChallengeChaseTagP2-v0", ChaseTagEnv, max_episode_steps=2000,
    kwargs=dict(
        model_path=asset("envs/myo/assets/leg/myolegs_chasetag.xml"),
        normalize_act=True,
        win_distance=0.5,
        min_spawn_distance=2,
        reset_type="random",
        terrain="random",
        task_choice="random",
        hills_range=(0.03, 0.23),
        rough_range=(0.05, 0.1),
        relief_range=(0.1, 0.3),
        chase_vel_range=(1.0, 1.0),
        random_vel_range=(-2, 2),
        opponent_probabilities=(0.1, 0.45, 0.45),
    ))

from myosuite_mjx_tpu.envs.bimanual import BimanualEnv  # noqa: E402

register(
    "myoChallengeBimanual-v0", BimanualEnv, max_episode_steps=1000,
    kwargs=dict(
        model_path=asset("envs/myo/assets/arm/myoarm_bionic_bimanual.xml"),
        normalize_act=True,
        frame_skip=5,
        obj_scale_change=[0.1, 0.05, 0.1],
        obj_mass_change=(-0.050, 0.050),
        obj_friction_change=(0.1, 0.001, 0.00002),
    ))

# ---- OSL RunTrack (MyoChallenge 2024, myochallenge/__init__.py:57-184) -----

from myosuite_mjx_tpu.envs.run_track import RunTrackEnv  # noqa: E402
from myosuite_mjx_tpu.models.assets import osl_runtrack_xml  # noqa: E402

# 24-patch difficulty ramp of the Random track (myochallenge/__init__.py:88)
_ramp = ((0.0,) * 5
         + tuple(x for i in range(8) for x in (0.03 * (i + 1), 0.0))[:-1]
         + (0.0,) * 4)

register(
    "myoChallengeOslRunFixed-v0", RunTrackEnv, max_episode_steps=1000,
    kwargs=dict(
        model_path=osl_runtrack_xml,
        normalize_act=True,
        reset_type="random",
        terrain="flat",
        hills_difficulties=(0.0, 0.1, 0.0, 0.5, 0.0, 0.8, 0.0, 1.0),
        rough_difficulties=(0.0, 0.1, 0.0, 0.15, 0.0, 0.2, 0.0, 0.3),
        stairs_difficulties=(0.0, 0.05, 0.0, 0.1, 0.0, 0.2, 0.0, 0.3),
        end_pos=-15,
        frame_skip=5,
        start_pos=14,
        init_pose_path=asset("envs/myo/assets/leg/sample_gait_cycle.csv"),
        max_episode_steps=1000,
    ))

register(
    "myoChallengeOslRunRandom-v0", RunTrackEnv, max_episode_steps=60000,
    kwargs=dict(
        model_path=osl_runtrack_xml,
        normalize_act=True,
        reset_type="random",
        terrain="random",
        hills_difficulties=_ramp,
        rough_difficulties=_ramp,
        stairs_difficulties=_ramp,
        end_pos=-45,
        frame_skip=5,
        start_pos=58,
        init_pose_path=asset("envs/myo/assets/leg/sample_gait_cycle.csv"),
        max_episode_steps=60000,
    ))
