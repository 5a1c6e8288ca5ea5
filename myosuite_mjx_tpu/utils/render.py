"""Host-side debug rendering of logged qpos frames.

The CPU MuJoCo twin renders offscreen via EGL (rendering stays host-side
by design, SURVEY.md §2.2 — the device path never produces pixels). Falls
back from mp4 to gif when no ffmpeg backend is available in the image.

``OffscreenRenderer`` is the capability twin of the reference's renderer
(/root/reference/myosuite/renderer/renderer.py:32-143 camera settings,
renderer/mj_renderer.py:80-158 offscreen rgb/depth/segmentation).
"""
from __future__ import annotations

import os


def _mujoco():
  """Import ``mujoco`` for rendering, defaulting to headless EGL unless the
  user chose a GL backend or has a display for the glfw viewer. MuJoCo picks
  its GL backend when it is first imported, so a process that renders and
  also compiles MJCF first should set ``MUJOCO_GL`` before either."""
  if "MUJOCO_GL" not in os.environ and "DISPLAY" not in os.environ:
    os.environ["MUJOCO_GL"] = "egl"
  import mujoco
  return mujoco


class OffscreenRenderer:
  """Offscreen rgb / depth / segmentation frames with camera settings."""

  def __init__(self, model_path: str, height: int = 240, width: int = 320):
    mujoco = _mujoco()
    self._mujoco = mujoco
    self.model = mujoco.MjModel.from_xml_path(model_path)
    self.data = mujoco.MjData(self.model)
    self._renderer = mujoco.Renderer(self.model, height=height, width=width)
    self._free_cam = mujoco.MjvCamera()
    mujoco.mjv_defaultFreeCamera(self.model, self._free_cam)
    self._use_free = False

  def set_free_camera_settings(self, distance=None, azimuth=None,
                               elevation=None, lookat=None):
    """Reference Renderer.set_free_camera_settings parity
    (renderer.py:96-120)."""
    cam = self._free_cam
    if distance is not None:
      cam.distance = float(distance)
    if azimuth is not None:
      cam.azimuth = float(azimuth)
    if elevation is not None:
      cam.elevation = float(elevation)
    if lookat is not None:
      cam.lookat[:] = lookat
    self._use_free = True

  def set_state(self, qpos, qvel=None):
    self.data.qpos[:] = qpos
    if qvel is not None:
      self.data.qvel[:] = qvel
    self._mujoco.mj_forward(self.model, self.data)

  def _scene(self, camera_id=-1):
    cam = self._free_cam if (self._use_free and camera_id == -1) \
        else camera_id
    self._renderer.update_scene(self.data, camera=cam)

  def render_offscreen(self, camera_id=-1, rgb=True, depth=False,
                       segmentation=False):
    """rgb [H,W,3] uint8 / depth [H,W] float32 meters / seg [H,W,2] int32
    (geom id + geom type), matching mj_renderer.py:80-158 capability."""
    out = {}
    if rgb:
      self._renderer.disable_depth_rendering()
      self._renderer.disable_segmentation_rendering()
      self._scene(camera_id)
      out["rgb"] = self._renderer.render()
    if depth:
      self._renderer.enable_depth_rendering()
      self._scene(camera_id)
      out["depth"] = self._renderer.render()
      self._renderer.disable_depth_rendering()
    if segmentation:
      self._renderer.enable_segmentation_rendering()
      self._scene(camera_id)
      out["segmentation"] = self._renderer.render()
      self._renderer.disable_segmentation_rendering()
    if len(out) == 1:
      return next(iter(out.values()))
    return out

  def close(self):
    self._renderer.close()


def render_camera_grid(model_path: str, qpos, cameras=None,
                       frame_size=(320, 240)):
  """Render one state from several cameras into a row grid of rgb images
  (reference utils/render_cams.py:54 capability)."""
  import numpy as np
  r = OffscreenRenderer(model_path, height=frame_size[1],
                        width=frame_size[0])
  r.set_state(qpos)
  if cameras is None:
    cameras = list(range(max(r.model.ncam, 1))) if r.model.ncam else [-1]
  frames = [r.render_offscreen(camera_id=c) for c in cameras]
  r.close()
  return np.concatenate(frames, axis=1)


def render_qpos_frames(model_path: str, qpos_frames, out_path: str,
                       camera=None, fps: int = 25,
                       frame_size=(320, 240)) -> str:
  """Render a sequence of qpos vectors; returns the path actually written."""
  import imageio
  mujoco = _mujoco()

  mj = mujoco.MjModel.from_xml_path(model_path)
  renderer = mujoco.Renderer(mj, height=frame_size[1], width=frame_size[0])
  d = mujoco.MjData(mj)

  try:
    writer = imageio.get_writer(out_path, fps=fps)
  except ValueError:
    # no mp4 backend (ffmpeg absent): fall back to animated gif
    out_path = os.path.splitext(out_path)[0] + ".gif"
    writer = imageio.get_writer(out_path, fps=fps)
  with writer as w:
    for qpos in qpos_frames:
      d.qpos[:] = qpos
      mujoco.mj_forward(mj, d)
      renderer.update_scene(d, camera=camera if camera else -1)
      w.append_data(renderer.render())
  return out_path
