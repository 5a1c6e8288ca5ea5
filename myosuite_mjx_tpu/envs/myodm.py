"""MyoDM task registrations: motion tracking + fixed/random object tasks.

ID parity with the reference registry
(/root/reference/myosuite/envs/myo/myodm/__init__.py:565-692): the explicit
track-task table (name, object, motion clip) is extracted from the reference
registry source so names match exactly; the 49 objects get Fixed/Random
goal-pose variants with the same synthetic references.
"""
from __future__ import annotations

import os
import re

import numpy as np

from myosuite_mjx_tpu.envs.registry import ASSET_ROOT, register, register_lazy
from myosuite_mjx_tpu.envs.track import TrackEnv
from myosuite_mjx_tpu.models import assets

_DOF_ROBOT = 29

OBJECTS = (
    "airplane", "alarmclock", "apple", "banana", "binoculars", "bowl",
    "camera", "coffeemug", "cubelarge", "cubemedium", "cubesmall", "cup",
    "cylinderlarge", "cylindermedium", "cylindersmall", "duck", "elephant",
    "eyeglasses", "flashlight", "flute", "gamecontroller", "hammer", "hand",
    "headphones", "knife", "lightbulb", "mouse", "mug", "phone", "piggybank",
    "pyramidlarge", "pyramidmedium", "pyramidsmall", "scissors",
    "spherelarge", "spheremedium", "spheresmall", "stamp", "stanfordbunny",
    "stapler", "teapot", "toothbrush", "toothpaste", "toruslarge",
    "torusmedium", "torussmall", "train", "watch", "waterbottle",
    "wineglass",
)


def _register_track_tasks():
  """Register the (task name, object, motion clip) triplets listed in the
  reference registry source — data extraction for exact ID parity. Runs on
  first registry lookup; registers nothing without the asset tree."""
  src = os.path.join(ASSET_ROOT, "envs/myo/myodm/__init__.py")
  if not os.path.exists(src):
    return
  with open(src) as f:
    text = f.read()
  pattern = re.compile(
      r'name="(?P<name>MyoHand\w+-v0)",\s*'
      r'robot="MyoHand",\s*'
      r'object="(?P<object>\w+)",\s*'
      r'motion="(?P<motion>[\w.]+)",', re.S)
  for match in pattern.finditer(text):
    clip = assets.myodm_clip(match["motion"])
    if os.path.exists(clip):
      register(
          match["name"], TrackEnv, max_episode_steps=75,
          kwargs=dict(object_name=match["object"], reference=clip,
                      normalize_act=True))


register_lazy(_register_track_tasks)


def _register_object_tasks(object_name: str):
  register(
      f"MyoHand{object_name.title()}Fixed-v0", TrackEnv,
      max_episode_steps=50,
      kwargs=dict(
          object_name=object_name,
          reference={
              "time": np.array((0.0, 4.0)),
              "robot": np.zeros((1, _DOF_ROBOT)),
              "robot_vel": np.zeros((1, _DOF_ROBOT)),
              "object_init": np.array((-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, 0.0)),
              "object": np.reshape(
                  np.array((0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 0.1)), (1, 7)),
          },
          normalize_act=True))
  register(
      f"MyoHand{object_name.title()}Random-v0", TrackEnv,
      max_episode_steps=50,
      kwargs=dict(
          object_name=object_name,
          reference={
              "time": np.array((0.0, 4.0)),
              "robot": np.zeros((2, _DOF_ROBOT)),
              "robot_vel": np.zeros((2, _DOF_ROBOT)),
              "object_init": np.array((0.0, 0.0, 0.1, 1.0, 0.0, 0.0, 0.0)),
              "object": np.array([
                  [-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, -1.0],
                  [0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 1.0],
              ]),
          },
          normalize_act=True))


for _obj in OBJECTS:
  _register_object_tasks(_obj)
