"""ops/linalg: the batched SPD solve against NumPy, as the engine calls it
(jit + vmap), at sizes from a scalar to the synthetic hand's nv."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myosuite_mjx_tpu.ops import linalg

BATCH = 37  # not a multiple of any block size


def _spd(n, seed=0):
  rng = np.random.default_rng(seed)
  j = rng.normal(size=(BATCH, n + 3, n))
  a = np.einsum("bki,bkj->bij", j, j) + 0.1 * np.eye(n)
  return a, rng.normal(size=(BATCH, n))


def _tol(dtype):
  return 2e-4 if dtype == jnp.float32 else 1e-10


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n", [1, 5, 23, 29])
def test_spd_solve(n, dtype):
  a, b = _spd(n)
  x = jax.jit(jax.vmap(linalg.spd_solve))(jnp.asarray(a, dtype),
                                          jnp.asarray(b, dtype))
  assert x.dtype == dtype and x.shape == (BATCH, n)
  want = np.linalg.solve(a, b[..., None])[..., 0]
  err = np.linalg.norm(np.asarray(x) - want, axis=-1) / np.linalg.norm(
      want, axis=-1)
  assert err.max() < _tol(dtype) * np.linalg.cond(a).max() ** 0.5


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n", [1, 5, 23, 29])
def test_chol_factor(n, dtype):
  a, _ = _spd(n, seed=1)
  L = np.asarray(jax.jit(jax.vmap(linalg.chol_factor))(jnp.asarray(a, dtype)))
  want = np.linalg.cholesky(a)
  assert np.allclose(np.triu(L, 1), 0.0)
  np.testing.assert_allclose(L, want, rtol=_tol(dtype) * 10,
                             atol=_tol(dtype) * np.abs(want).max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n", [1, 5, 23, 29])
def test_cho_solve_vector_and_matrix_rhs(n, dtype):
  a, b = _spd(n, seed=2)
  L = jnp.asarray(np.linalg.cholesky(a), dtype)
  rhs = np.stack([b, 2.0 * b + 1.0], axis=-1)          # [B, n, 2]
  solve = jax.jit(jax.vmap(linalg.cho_solve))
  x1 = np.asarray(solve(L, jnp.asarray(b, dtype)))
  x2 = np.asarray(solve(L, jnp.asarray(rhs, dtype)))
  want = np.linalg.solve(a, rhs)
  scale = np.abs(want).max() * np.linalg.cond(a).max() ** 0.5
  np.testing.assert_allclose(x1, want[..., 0], atol=_tol(dtype) * scale)
  np.testing.assert_allclose(x2, want, atol=_tol(dtype) * scale)


def _scene_mass_matrices(count, seed):
  """MuJoCo's joint-space inertia of the synthetic hand at random hinge
  angles (float64)."""
  import mujoco
  from myosuite_mjx_tpu.engine import model as emodel
  from myosuite_mjx_tpu.models import synthetic
  mj = emodel.load_mj_model(synthetic.XML_PATH)
  d = mujoco.MjData(mj)
  rng = np.random.default_rng(seed)
  hinges = np.where(mj.jnt_type == mujoco.mjtJoint.mjJNT_HINGE)[0]
  out = np.zeros((count, mj.nv, mj.nv))
  for i in range(count):
    d.qpos[:] = mj.qpos0
    for j in hinges:
      d.qpos[mj.jnt_qposadr[j]] = rng.uniform(*mj.jnt_range[j])
    mujoco.mj_forward(mj, d)
    mujoco.mj_fullM(mj, d, out[i])
  return out


@pytest.mark.parametrize("seed", range(2))
def test_spd_solve_f32_scene_mass_matrices(seed):
  """The synthetic hand's mass matrices factor in f32 with a finite answer
  close to float64: tiny sphere inertias (2.7e-6) beside armature-weighted
  hinges leave every pivot far above f32 rounding."""
  a = _scene_mass_matrices(8, seed)
  b = np.random.default_rng(seed).normal(size=a.shape[:2])
  x = np.asarray(jax.jit(jax.vmap(linalg.spd_solve))(
      jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)), np.float64)
  assert np.isfinite(x).all()
  want = np.linalg.solve(a, b[..., None])[..., 0]
  err = np.linalg.norm(x - want, axis=-1) / np.linalg.norm(want, axis=-1)
  assert err.max() < 1e-4


@pytest.mark.parametrize("pivot", [0.0, -1e-9])
def test_not_positive_definite_gives_nan(pivot):
  """Callers pass positive-definite matrices (MuJoCo's compiler refuses
  moving bodies without mass or inertia; the solver and the implicit
  integrator only add positive semidefinite terms to M). A matrix that is
  not PD in the working precision -- a massless dof -- gives NaN, so the
  fault shows instead of a finite but meaningless answer."""
  a = np.diag(np.linspace(1.0, 2.0, 5)).astype(np.float32)
  a[2, 2] = pivot
  L = np.asarray(linalg.chol_factor(jnp.asarray(a)))
  x = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.ones(5, jnp.float32)))
  assert np.isnan(L).any() and np.isnan(x).all()


def test_tiny_uncoupled_pivot_f32():
  """A positive pivot far below the others (a 1e-12 inertia) is kept, not
  clamped: the answer is b_j / pivot."""
  a = np.diag([1.0, 0.5, 1e-12, 2.0]).astype(np.float32)
  b = np.ones(4, np.float32)
  x = np.asarray(linalg.spd_solve(jnp.asarray(a), jnp.asarray(b)))
  np.testing.assert_allclose(x, 1.0 / np.diag(a), rtol=1e-6)
