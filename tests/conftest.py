"""Test configuration: run JAX on a virtual multi-device CPU mesh.

The tests run on the CPU; all sharding/multi-device tests run against 8
virtual CPU devices (the pattern recommended for jax.distributed simulation,
mirroring the reference's CPU-forced math tests in
myosuite/tests/mjx/test_quat_math.py:7). The GPU path is checked by
``chip_smoke.py`` on a card.

Parity tests against the CPU MuJoCo oracle run in float64 (enabled here
globally for the test process; the production path is float32).
"""
import os

# MuJoCo picks its GL backend when first imported, which in a test process
# is usually an MJCF compile before any render: headless EGL by default.
if "MUJOCO_GL" not in os.environ and "DISPLAY" not in os.environ:
  os.environ["MUJOCO_GL"] = "egl"

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU even where a GPU is visible; must run before backend initialization.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: env reset/step jits dominate test wall time
# (hand/leg scenes take minutes to compile on CPU); cached executables cut
# repeat runs to seconds. Entries are content-addressed and written
# atomically (temp + rename, see utils/compile_cache.py) so a killed test
# run cannot leave truncated entries that segfault later readers.
import sys  # noqa: E402
sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), os.pardir)))
from myosuite_mjx_tpu.utils import compile_cache  # noqa: E402
compile_cache.enable()
