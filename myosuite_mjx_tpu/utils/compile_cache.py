"""Crash-safe persistent XLA compilation cache.

JAX's ``LRUCache.put`` writes cache entries with a bare
``Path.write_bytes`` (jax/_src/lru_cache.py): a writer killed mid-write
(ctrl-C on a test run, OOM kill) leaves a truncated entry on disk, and a
later reader segfaults inside the XLA executable deserializer.  Two
defenses here:

1. ``enable()`` monkeypatches the write to go through a temp file in
   the same directory followed by ``os.replace`` (atomic on POSIX), so a
   killed writer leaves only a stray ``*.tmp`` that no reader opens.
2. ``sweep_partial(path)`` removes leftover ``*.tmp`` files and
   zero-length entries from crashes that predate the patch.
3. Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache is exactly that
   directory. Otherwise it is ``<checkout>/.jax_cache/<host tag>``, the tag
   keyed by CPU feature flags + jax version: XLA:CPU persists AOT
   executables specialized to the *compiling* machine's features, and
   loading one on a host with a different feature set warns "could lead
   to execution errors such as SIGILL". The path is fixed for a checkout
   and host, because it is part of what a later run must find again.

Use from any entry point that turns the cache on (tests/conftest.py,
train CLI, bench, chip_smoke, tools/).  The reference has no equivalent (its CI recompiles
from scratch each run, /root/reference/.github/workflows/test.yml:36-38).
"""
from __future__ import annotations

import os
import tempfile

import jax

_patched = False


def _patch_atomic_put() -> None:
  """Make LRUCache entry writes atomic (temp file + rename)."""
  global _patched
  if _patched:
    return
  try:
    from jax._src import lru_cache as _lru
  except ImportError:      # future jax moved the module: fail open
    _patched = True
    return

  def _atomic_write_bytes(path, val):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               suffix=".tmp")
    try:
      with os.fdopen(fd, "wb") as f:
        f.write(val)
      os.replace(tmp, path)
    except BaseException:
      try:
        os.unlink(tmp)
      except OSError:
        pass
      raise

  orig_put = _lru.LRUCache.put

  def put(self, key, val):
    # Reuse the original logic but swap Path.write_bytes for the atomic
    # variant on this instance's path objects only.
    cls = type(self.path)

    class _AtomicPath(cls):
      def write_bytes(p, data):          # noqa: N805
        _atomic_write_bytes(str(p), data)
        return len(data)

    real_path = self.path
    try:
      self.path = _AtomicPath(str(real_path))
      return orig_put(self, key, val)
    finally:
      self.path = real_path

  _lru.LRUCache.put = put
  _patched = True


def sweep_partial(path: str) -> int:
  """Remove stray temp files / zero-length entries. Returns count removed."""
  removed = 0
  if not os.path.isdir(path):
    return 0
  for name in os.listdir(path):
    full = os.path.join(path, name)
    try:
      if name.endswith(".tmp") or (
          os.path.isfile(full) and os.path.getsize(full) == 0
          and not name.startswith(".")):
        os.unlink(full)
        removed += 1
    except OSError:
      pass
  return removed


def _host_tag() -> str:
  """Fingerprint of what XLA:CPU AOT results are specialized to."""
  import hashlib
  import platform
  feats = ""
  try:
    with open("/proc/cpuinfo") as f:
      for line in f:
        if line.startswith(("flags", "Features")):
          feats = line
          break
  except OSError:
    pass
  raw = f"{platform.machine()}|{feats}|{jax.__version__}"
  return "host-" + hashlib.sha1(raw.encode()).hexdigest()[:10]


def cache_dir() -> str:
  """``$JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's own."""
  env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
  if env:
    return env
  checkout = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  return os.path.join(checkout, ".jax_cache", _host_tag())


def enable() -> str:
  """Turn on the persistent compile cache at ``cache_dir()``,
  crash-safely. Returns the directory."""
  path = cache_dir()
  os.makedirs(path, exist_ok=True)
  _patch_atomic_put()
  sweep_partial(path)
  jax.config.update("jax_compilation_cache_dir", path)
  jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
  jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
  return path
