"""Random JAX variables for any image model of the zoo, for the port's
parity tests, without running the JAX initialisers: the tree's structure
and shapes come from ``jax.eval_shape``, the values from numpy. The
port then carries them across with its ``load_jax_*``."""

import math

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(model, x_shape, seed=0, fresh=False):
    """``(params, batch_stats)`` numpy trees for the flax ``model`` on
    inputs of ``x_shape``: shapes from ``jax.eval_shape``, values from
    numpy (kernels scaled by their fan-in, the rest around their usual
    values). ``fresh`` draws what a freshly initialised model holds
    instead: normal kernels scaled by their fan-in, zero biases, unit
    norm scales, BN running stats 0 and 1, ``gamma`` 1e-6."""
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if fresh and name != "kernel":
            v = (np.ones(shape) if name in ("scale", "var")
                 else np.full(shape, 1e-6) if name == "gamma"
                 else np.zeros(shape))
        elif name == "kernel":
            v = rng.normal(0.0, math.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "gamma":
            v = rng.normal(0.0, 0.5, shape)
        elif name == "pos_embed":
            v = rng.normal(0.0, 0.02, shape)
        else:  # bias, mean, cls
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        leaf, shapes.get("batch_stats", {}))
    return params, stats
