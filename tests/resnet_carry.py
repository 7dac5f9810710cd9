"""Random JAX ResNet variables for the port's image tests, without
running the JAX initialisers (``model.init`` dispatches op by op and
takes seconds): the tree's structure and shapes come from
``jax.eval_shape``, the values from numpy. The port then carries them
across with ``load_jax_resnet``."""

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(model, seed=0, random_bn=True):
    """``(params, batch_stats)`` numpy trees for ``model`` on 32x32x3
    inputs: He-normal conv kernels, a scaled normal head, and (with
    ``random_bn``) random BN scales, biases and running stats so that
    neither BN mode normalizes trivially; otherwise the JAX defaults
    (scale 1, bias 0, mean 0, var 1)."""
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        parent, name = path[-2].key, path[-1].key
        shape = a.shape
        if parent == "conv":
            fan_out = shape[0] * shape[1] * shape[3]
            v = rng.normal(0.0, np.sqrt(2.0 / fan_out), shape)
        elif parent == "linear":
            v = (rng.normal(0.0, np.sqrt(1.0 / shape[0]), shape)
                 if name == "kernel" else np.zeros(shape))
        elif not random_bn:
            v = np.ones(shape) if name in ("scale", "var") else np.zeros(shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(leaf, shapes["batch_stats"])
    return params, stats
