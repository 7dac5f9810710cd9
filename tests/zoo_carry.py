"""Random JAX variables for any image model of the zoo, for the port's
parity tests, without running the JAX initialisers: the tree's structure
and shapes come from ``jax.eval_shape``, the values from numpy. The
port then carries them across with its ``load_jax_*``; a whole JAX
train state (params, BN stats, momenta or LAMB's moments, the EMA)
crosses as the port's checkpoint payload (:func:`port_payload`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch


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


def port_payload(jax_state, carry):
    """A host JAX ``TrainState`` as the port's checkpoint payload
    (``TrainState.to_dict``'s keys; ``load_dict`` takes it): params and
    BN running stats through ``carry`` (``load_jax_resnet`` or another
    ``load_jax_*``), each moment tree the same way (``momentum``, or
    LAMB's ``mu`` and ``nu``), ``ema_params`` where the state tracks an
    EMA, the count, ``initialized`` (False for LAMB, which has none) and
    the epoch. A ``ZeroOptState`` must be gathered first (JAX's
    ``parallel.zero.gather_opt_state``)."""
    stats = jax_state.batch_stats
    sd = carry(jax_state.params, stats)
    running = ("running_mean", "running_var")
    names = [k for k in sd if not k.endswith(running)]
    out = {}
    for k, v in sd.items():
        prefix = "batch_stats" if k.endswith(running) else "params"
        out[f"{prefix}/{k.replace('.', '/')}"] = v
    opt = jax_state.opt_state
    trees = ({"momentum": opt.momentum} if hasattr(opt, "momentum")
             else {"mu": opt.mu, "nu": opt.nu})
    if jax_state.ema_params:
        trees["ema"] = jax_state.ema_params
    for field, tree in trees.items():
        prefix = "ema_params" if field == "ema" else f"opt_state/{field}"
        msd = carry(tree, stats)
        for k in names:
            out[f"{prefix}/{k.replace('.', '/')}"] = msd[k]
    out["opt_state/count"] = torch.tensor(np.asarray(opt.count, np.int32))
    out["opt_state/initialized"] = torch.tensor(
        bool(np.asarray(getattr(opt, "initialized", False))))
    out["epoch"] = int(np.asarray(jax_state.epoch))
    return out
