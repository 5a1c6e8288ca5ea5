"""utils.pytree.dataclass: the state containers of the engine, envs and
trainers (replacing flax.struct)."""
import jax
import jax.numpy as jnp
import numpy as np

from myosuite_mjx_tpu.train import checkpoint
from myosuite_mjx_tpu.utils import pytree


@pytree.dataclass
class Inner:
  a: jax.Array
  b: dict


@pytree.dataclass
class Outer:
  x: jax.Array
  inner: Inner


def _tree():
  return Outer(x=jnp.arange(3.0),
               inner=Inner(a=jnp.ones((2, 2)), b={"k": jnp.zeros(4)}))


def test_flatten_order_key_paths_and_replace():
  t = _tree()
  paths = [jax.tree_util.keystr(p)
           for p, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
  assert paths == [".x", ".inner.a", ".inner.b['k']"]
  t2 = t.replace(x=jnp.zeros(3))
  assert float(t2.x.sum()) == 0.0 and t2.inner is t.inner
  doubled = jax.jit(lambda s: jax.tree.map(lambda v: 2 * v, s))(t)
  assert isinstance(doubled, Outer)
  np.testing.assert_array_equal(doubled.inner.a, 2 * np.ones((2, 2)))
  batched = jax.vmap(lambda s: s.replace(x=s.x + 1))(
      jax.tree.map(lambda v: jnp.stack([v, v]), t))
  assert batched.x.shape == (2, 3)


def test_checkpoint_round_trip(tmp_path):
  t = _tree().replace(x=jnp.asarray([1.0, 2.0, 3.0]))
  checkpoint.save(str(tmp_path / "ck"), t)
  back = checkpoint.restore(str(tmp_path / "ck"), _tree())
  assert isinstance(back, Outer)
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
