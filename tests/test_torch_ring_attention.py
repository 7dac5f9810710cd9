"""The port's sequence-parallel attention against the JAX package's.

JAX's ``ring_attention`` (contiguous and zigzag) and
``ulysses_attention`` run under ``shard_map`` on N of the conftest's
virtual CPU devices, through the Pallas flash kernels in interpret mode;
the port's run on N gloo ranks started with ``torch.multiprocessing``
(``tests/torch_sp_worker.py``), through the plain flash versions. The
same numpy q/k/v and output cotangent go in (in the zigzag layout for
zigzag); outputs and the gradients of q, k and v agree within 2e-5
(JAX's own tolerance for its ring). The hop schedule, ``zigzag_indices``,
the sequence shard's next-token targets and the argument checks are
pinned against JAX's functions directly.
"""

import importlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
    ring_attention as ring_mod)
from pytorch_multiprocessing_distributed_tpu_torch.parallel import ulysses
from pytorch_multiprocessing_distributed_tpu_torch.train.lm import (
    _next_token_targets, seq_columns)

from torch_sp_worker import attention_rank

# the JAX package's parallel/__init__ re-exports the functions under the
# modules' names
jax_ring_mod = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu.parallel.ring_attention")
jax_ulysses = importlib.import_module(
    "pytorch_multiprocessing_distributed_tpu.parallel.ulysses")

B, S, H, D = 2, 32, 4, 8
TOL = 2e-5
CASES = ("ring_causal", "ring_full", "zigzag_causal", "ulysses_causal",
         "ulysses_full")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {n: rng.normal(size=(B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


@pytest.fixture(scope="module", params=[2, 4])
def port_runs(request, inputs, tmp_path_factory):
    """Every case on ``n`` gloo ranks, each rank's results in rank
    order (one spawn per ``n``)."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"ring{n}")
    path, out = tmp / "inputs.pt", tmp / "out"
    torch.save({**{k: torch.from_numpy(v) for k, v in inputs.items()},
                "cases": list(CASES)}, path)
    mp.spawn(attention_rank, args=(n, _free_port(), str(path), str(out)),
             nprocs=n, join=True)
    return n, [torch.load(f"{out}.{r}", weights_only=True)
               for r in range(n)]


def _jax_case(case, n, inputs):
    """JAX's output and q/k/v gradients for ``case`` on ``n`` devices,
    in the shard layout (zigzag inputs permuted first)."""
    kind, causal = case.split("_")
    causal = causal == "causal"
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    arrs = dict(inputs)
    if kind == "zigzag":
        perm = jax_ring_mod.zigzag_indices(S, n).reshape(-1)
        arrs = {k: v[:, perm] for k, v in arrs.items()}
    if kind == "ulysses":
        def attn(q, k, v):
            return jax_ulysses.ulysses_attention(q, k, v, axis_name="seq",
                                                 causal=causal)
    else:
        def attn(q, k, v):
            return jax_ring_mod.ring_attention(
                q, k, v, axis_name="seq", causal=causal,
                zigzag=kind == "zigzag")
    fn = jax.shard_map(attn, mesh=mesh, in_specs=P(None, "seq"),
                       out_specs=P(None, "seq"), check_vma=False)

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    got = run(*(jnp.asarray(arrs[n_]) for n_ in ("q", "k", "v", "do")))
    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(x) for x in got)))


@pytest.mark.parametrize("case", CASES)
def test_matches_jax(port_runs, inputs, case):
    n, ranks = port_runs
    ref = _jax_case(case, n, inputs)
    for key, want in ref.items():
        got = torch.cat([r[case][key] for r in ranks], dim=1).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0,
                                   err_msg=f"{case} {key} n={n}")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_hop_schedule_matches_jax_cases(n):
    """The schedule is JAX's ``_hop_cases`` and zigzag quadrants hop by
    hop, and folds ``i + 1`` blocks on seq rank ``i`` (causal ring), ``n``
    (not causal) and ``2n + 1`` half-blocks (zigzag)."""
    for my in range(n):
        for causal in (True, False):
            hops = ring_mod.hop_schedule(n, my, causal)
            assert [src for src, _ in hops] == [(my - h) % n
                                                for h in range(n)]
            for src, quads in hops:
                fold, diag = jax_ring_mod._hop_cases(src, my, causal)
                assert quads == ([("all", "all", bool(diag))]
                                 if bool(fold) else [])
            assert sum(len(q) for _, q in hops) == (my + 1 if causal
                                                    else n)
        zig = ring_mod.hop_schedule(n, my, zigzag=True)
        for src, quads in zig:
            want = ([("a", "c", src == my)] if src <= my else [])
            want += [("b", "c", False)]
            want += [("b", "d", src == my)] if src >= my else []
            assert quads == want
        assert sum(len(q) for _, q in zig) == 2 * n + 1


@pytest.mark.parametrize("s,n", [(16, 1), (16, 2), (24, 3), (32, 4)])
def test_zigzag_indices_equal_jax(s, n):
    np.testing.assert_array_equal(ring_mod.zigzag_indices(s, n),
                                  jax_ring_mod.zigzag_indices(s, n))
    for i in range(n):
        np.testing.assert_array_equal(
            seq_columns(s, n, i, zigzag=True),
            jax_ring_mod.zigzag_indices(s, n)[i])
    with pytest.raises(ValueError) as ours:
        ring_mod.zigzag_indices(s + 1, n)
    with pytest.raises(ValueError) as ref:
        jax_ring_mod.zigzag_indices(s + 1, n)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_targets_equal_jax_ppermute(n, zigzag):
    """Targets formed on the whole rows then sliced to a shard's columns
    equal JAX's ``_next_token_targets`` under ``shard_map`` (its
    ppermute of neighbour columns) at every valid position, and the
    valid masks are equal (JAX's one invalid position holds a wrapped
    token, the port's a 0; no loss reads it)."""
    tokens = np.random.default_rng(3).integers(0, 257, (3, 32)).astype(
        np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    laid = (tokens[:, jax_ring_mod.zigzag_indices(32, n).reshape(-1)]
            if zigzag else tokens)
    fn = jax.jit(jax.shard_map(
        lambda t: jax_lm._next_token_targets(t, "seq", zigzag), mesh=mesh,
        in_specs=P(None, "seq"), out_specs=P(None, "seq"),
        check_vma=False))
    jt, jv = (np.asarray(x) for x in fn(jnp.asarray(laid)))
    rows = torch.from_numpy(tokens)
    for i in range(n):
        cols = torch.from_numpy(seq_columns(32, n, i, zigzag))
        tgt, valid = _next_token_targets(rows, cols)
        sl = slice(i * 32 // n, (i + 1) * 32 // n)
        np.testing.assert_array_equal(valid.numpy(), jv[:, sl])
        np.testing.assert_array_equal(
            np.where(jv[:, sl], tgt.numpy(), -1),
            np.where(jv[:, sl], jt[:, sl], -1))
        assert (~jv[:, sl]).sum() == (3 if i == (0 if zigzag else n - 1)
                                      else 0)


def test_checks_keep_jax_words():
    with pytest.raises(ValueError) as ours:
        ulysses._check_heads(6, 4)
    with pytest.raises(ValueError) as ref:
        jax_ulysses._check_heads(6, 4)
    assert str(ours.value) == str(ref.value)
    assert "use ring_attention for head counts" in str(ours.value)
    q = torch.zeros(1, 6, 2, 8)
    jq = jnp.zeros((1, 6, 2, 8))
    for kw, bad in ((dict(causal=False), q), (dict(causal=True), q[:, :5])):
        with pytest.raises(ValueError) as ours:
            ring_mod.ring_attention(bad, bad, bad, zigzag=True, **kw)
        with pytest.raises(ValueError) as ref:
            jax_ring_mod.ring_attention(jq[:, :bad.shape[1]],
                                        jq[:, :bad.shape[1]],
                                        jq[:, :bad.shape[1]],
                                        axis_name="seq", zigzag=True, **kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="seq_len 30 is not divisible"):
        seq_columns(30, 4, 0)
