"""The port's sharded weight update (``--zero``,
``pytorch_multiprocessing_distributed_tpu_torch/parallel/zero.py``)
against the JAX package's ``parallel/zero.py``.

- ``plan_buckets``: the port's buckets hold the same leaves (port names
  mapped to their flax paths), in the same order, with the same totals,
  padded sizes and shards, and ``static_comm_bytes`` agrees, for
  ResNet-18, ResNet-50 and ViT-Tiny at world sizes 2-4 and at bucket
  sizes small enough to force several buckets (shapes only: no weights).
- The sharded update is bit-equal to the replicated ``update_`` fed the
  same reduced gradients, for SGD and LAMB, with ``world`` ranks'
  shards emulated in this process (no collectives), a skipped step
  included; at world 1 through ``apply_sharded_update`` itself.
- ``--zero`` on two spawned gloo ranks (``tests/image_step_cases.py``'s
  small ResNet, 3 steps): bit-equal to the replicated run there, each
  rank holding half of the moments; each step from JAX's state held
  within 1e-5 against JAX ``make_train_step(zero=True)`` on 2 virtual
  devices, with and without clipping; and a ``--zero`` state's
  checkpoint payload (moments gathered) resumed by a replicated run,
  and the other way round, equal to the straight run.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.parallel import zero as jzero
from pytorch_multiprocessing_distributed_tpu_torch.models import get_model
from pytorch_multiprocessing_distributed_tpu_torch.models.init import (
    jax_param_path)
from pytorch_multiprocessing_distributed_tpu_torch.parallel import zero
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_train_state)

from image_step_cases import (ARCH, STEPS, assert_transitions_match,
                              family, jax_trajectory, make_spec, port_run,
                              transitions, worker_inputs)
from torch_image_worker import (build_model, make_optimizer, run_steps,
                                spawn_ranks, steps_rank)

MIB = 2 ** 20
CLIP = {"clip_grad_norm": 0.5}


@pytest.fixture(autouse=True)
def _torch_cpu_state():
    """One intra-op thread and PyTorch's native convolutions (oneDNN
    off) for this file's torch work, both restored after."""
    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn


@pytest.mark.parametrize("name,image,world,bucket_mb", [
    ("res", 32, 2, None), ("res", 32, 4, None), ("res", 32, 4, 2.0),
    ("res", 32, 3, 0.5), ("resnet50", 64, 4, None), ("resnet50", 64, 2, 8.0),
    ("vit_tiny", 32, 4, 0.25)])
def test_plan_matches_jax(name, image, world, bucket_mb):
    stem = "imagenet" if name == "resnet50" else "cifar"
    jmodel = jax_models.get_model(name, stem=stem)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((2, image, image, 3), jnp.float32))["params"]
    bucket_bytes = None if bucket_mb is None else int(bucket_mb * MIB)
    ref = jzero.plan_buckets(shapes, world, bucket_bytes=bucket_bytes)
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = get_model(name, stem=stem, image_size=image)
    path_of = getattr(model, "jax_param_path", jax_param_path)
    shape_of = dict(model.named_parameters())
    plan = zero.plan_buckets(model, world, bucket_bytes=bucket_bytes)
    assert len(plan.buckets) == len(ref.buckets)
    if bucket_mb is not None and name != "vit_tiny":
        assert len(plan.buckets) > 1  # the small bucket splits the model
    for ours, theirs in zip(plan.buckets, ref.buckets):
        assert [path_of(n, shape_of[n].shape) for n in ours.names] == [
            paths[i] for i in theirs.leaf_idx]
        assert ours.sizes == theirs.sizes and ours.offsets == theirs.offsets
        assert (ours.total, ours.padded, ours.shard) == (
            theirs.total, theirs.padded, theirs.shard)
        assert theirs.dtype == "float32"  # the port's one dtype group
    assert zero.static_comm_bytes(plan) == jzero.static_comm_bytes(ref)
    assert plan.size == sum(b.padded for b in ref.buckets)


def _grads(state, seed):
    """Random reduced gradients in ``state``'s layout (zeros in pads)."""
    g = torch.zeros_like(state.params)
    gen = torch.Generator().manual_seed(seed)
    for _, off, shape in state.layout:
        g[off:off + shape.numel()] = torch.randn(shape.numel(),
                                                 generator=gen) * 1e-2
    return g


def _by_name(flat, state):
    return {name: v.clone() for name, v in state.views(flat).items()}


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_update_is_bit_equal_to_replicated(optimizer, world):
    """Four updates (the third skipped by the guard) from the same
    reduced gradients: the sharded phases on ``world`` ranks' shards
    (direction on each rank's shard, the directions gathered, the finish
    on full leaves) and the replicated ``update_`` give the same bits in
    params, moments and count. Buckets of 128 KiB: several per rank."""
    spec = make_spec()
    opt = make_optimizer(optimizer, 0.05)
    rep_model = build_model(ARCH)
    rep_model.load_state_dict(spec["state_dict"])
    rep = create_train_state(rep_model, opt)
    plan = zero.plan_buckets(rep_model, world, bucket_bytes=128 * 1024)
    assert len(plan.buckets) > 3
    ranks = []
    for r in range(world):
        m = build_model(ARCH)
        m.load_state_dict(spec["state_dict"])
        st = create_train_state(m, opt, plan=plan)
        zero.zeroify_state(st, plan, r)
        ranks.append(st)
    for t, keep in enumerate((True, True, False, True)):
        keep = torch.tensor(keep)
        g = _grads(ranks[0], seed=t)
        if world == 1:
            zero.apply_sharded_update(opt, ranks[0], g.clone(), keep, 0)
        else:
            d = [opt.direction_(st, zero.shard_params(g, plan, r),
                                zero.shard_params(st.params, plan, r),
                                st.momentum, st.nu, keep)
                 for r, st in enumerate(ranks)]
            full = torch.cat([d[r][b.shard_start:b.shard_start + b.shard]
                              for b in plan.buckets for r in range(world)])
            for st in ranks:
                opt.finish_(st, full, keep)
        rep_g = torch.zeros_like(rep.params)
        for name, v in _by_name(g, ranks[0]).items():
            rep.views(rep_g)[name].copy_(v)
        opt.update_(rep, rep_g, keep)
    moments = [("momentum", rep.momentum)] + (
        [("nu", rep.nu)] if rep.nu is not None else [])
    for field, rep_flat in moments:
        shards = [getattr(st, field) for st in ranks]
        full = torch.cat([s[b.shard_start:b.shard_start + b.shard]
                          for b in plan.buckets for s in shards])
        got = _by_name(full, ranks[0])
        for name, v in _by_name(rep_flat, rep).items():
            assert torch.equal(got[name], v), (field, name)
    for st in ranks:
        for name, v in _by_name(rep.params, rep).items():
            assert torch.equal(_by_name(st.params, st)[name], v), name
        assert int(st.count) == int(rep.count) == 3
    # each rank holds its shard of every bucket, pads included
    shard_size = sum(b.shard for b in plan.buckets)
    assert ranks[0].momentum.numel() == shard_size
    assert shard_size * world == plan.size >= rep.n


def test_zero_at_world_one_is_the_replicated_run():
    """One rank: ``--zero`` holds one shard and its 3 steps are bit-equal
    to the replicated run's, for SGD and LAMB."""
    spec = make_spec()
    for opt in ("sgd", "lamb"):
        plain = run_steps(spec, port_run("plain", opt, {}))
        sharded = run_steps(spec, port_run("zero", opt, {}, zero=True))
        assert plain["losses"] == sharded["losses"]
        for k, v in plain["state"].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, sharded["state"][k]), k


def test_zero_refuses_the_fused_update():
    model = build_model(ARCH)
    opt = make_optimizer("sgd_fused", 0.01)
    plan = zero.plan_buckets(model, 1)
    state = create_train_state(model, opt, plan=plan)
    zero.zeroify_state(state, plan, 0)
    with pytest.raises(ValueError, match="cannot run on shards"):
        zero.apply_sharded_update(opt, state, state.grad_shards,
                                  torch.tensor(True), 0)


@pytest.fixture(scope="module")
def zero_case(tmp_path_factory):
    """JAX ``zero=True`` on 2 virtual devices (SGD and LAMB, with and
    without clipping) and, in one spawn of two gloo ranks, the port's
    runs: replicated and ``--zero`` 3 chained steps, each JAX step from
    JAX's state, and the checkpoint round trips."""
    spec = make_spec()
    jax_runs = {(opt, clip): jax_trajectory(spec, family(opt), 2,
                                            CLIP if clip else {}, zero=True)
                for opt in ("sgd", "lamb") for clip in (False, True)}
    runs = []
    for opt in ("sgd", "lamb"):
        runs += [port_run("plain", opt, {}),
                 port_run("zero", opt, {}, zero=True),
                 port_run("plain2", opt, {}, steps=2),
                 port_run("zero2", opt, {}, zero=True, steps=2),
                 port_run("zero-from-plain", opt, {}, zero=True, start=2,
                          steps=1, resume_from=f"plain2-{opt}"),
                 port_run("plain-from-zero", opt, {}, start=2, steps=1,
                          resume_from=f"zero2-{opt}")]
        for clip in (False, True):
            name = "jax-clip" if clip else "jax"
            states = jax_runs[opt, clip][1]
            runs += [r | {"name": f"{r['name']}@{r['tag']}"}
                     for r in transitions(name, opt, CLIP if clip else {},
                                          states, zero=True)]
    tmp = tmp_path_factory.mktemp("zero2")
    inputs, out = tmp / "inputs.pt", tmp / "out.pt"
    torch.save(worker_inputs(spec, runs), inputs)
    spawn_ranks(steps_rank, 2, (str(inputs), str(out)))
    return jax_runs, torch.load(out, weights_only=True)


def _assert_equal_states(a, b):
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_zero_on_two_ranks_is_the_replicated_run(zero_case, optimizer):
    """Reduce-scatter, sharded update and all-gather on two gloo ranks:
    the same bits as the all-reduce and the replicated update, with each
    rank holding half of the (padded) moments."""
    _, res = zero_case
    plain, sharded = res[f"plain-{optimizer}"], res[f"zero-{optimizer}"]
    assert plain["losses"] == sharded["losses"]
    _assert_equal_states(plain["state"], sharded["state"])
    moments = 2 if optimizer == "lamb" else 1
    plan = zero.plan_buckets(build_model(ARCH), 2)
    assert sharded["opt_bytes"] == [moments * plan.shard_bytes] * 2
    assert plain["opt_bytes"] == [moments * 4 * sum(
        p.numel() for p in build_model(ARCH).parameters())] * 2
    assert 2 * sharded["opt_bytes"][0] == moments * plan.padded_bytes


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_zero_matches_jax_zero(zero_case, optimizer, clip):
    """Each of three steps from JAX's state (its sharded moments
    gathered by JAX's ``gather_opt_state``): the port's ``--zero`` step on
    two gloo ranks against JAX ``make_train_step(zero=True)`` on 2
    virtual devices, within 1e-5; with clipping, whose global norm both
    sum from the ranks' shards."""
    jax_runs, res = zero_case
    losses, states = jax_runs[optimizer, clip]
    name = "jax-clip" if clip else "jax"
    steps = [res[f"{name}-{optimizer}@{t}"] for t in range(STEPS)]
    assert_transitions_match(steps, losses, states)


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_zero_checkpoint_round_trips_with_replicated_runs(zero_case,
                                                          optimizer):
    """A ``--zero`` run's checkpoint payload after 2 steps (its moments
    gathered to the replicated format) resumed by a replicated run, and a
    replicated run's resumed under ``--zero``: the third step equals the
    straight 3-step runs bit for bit."""
    _, res = zero_case
    assert res[f"zero2-{optimizer}"]["state"]["opt_state/count"] == 2
    for resumed, straight in (("plain-from-zero", "plain"),
                              ("zero-from-plain", "zero")):
        got = res[f"{resumed}-{optimizer}"]
        ref = res[f"{straight}-{optimizer}"]
        assert got["losses"] == ref["losses"][2:]
        _assert_equal_states(ref["state"], got["state"])

