"""Mixture-of-Experts composed with tensor parallelism, FSDP (ZeRO-3),
sequence parallelism and ZeRO-1 in the port's ``torch.distributed`` world
on the CPU, held to the JAX package's MoE pipeline
(``tests/test_moe_pipeline.py:107-477``) on the simulated 8-device mesh.

One gloo world of 8 ranks (``parallel.selftest.run_cases`` under
``parallel.mesh.launch``; the children import neither jax nor this
module) runs every case on a thread while the JAX references compile
here. Every case's mesh has 8 ranks:

- MoE x TP (data 2 x pipe 2 x model 2, aux on), pipe 2 x model 2 x expert
  2, pp x fsdp (data 4 x pipe 2), fsdp x ep and fsdp x tp (data 2 x pipe
  2 x expert 2, x model 2), MoE x seq (data 2 x pipe 2 x seq 2, ring and
  Ulysses), seq x expert and tp x seq (pipe 2 x seq 2 x expert 2, pipe 2
  x model 2 x seq 2): the world's loss and every gradient leaf, merged
  over the ranks, within 2e-5 of JAX's oracle, the mean over (batch
  shard, microbatch) chunks of ``moe_lm_loss`` (the microbatched oracle
  of ``test_moe_pipeline.py:28``; zero-drop capacity, aux off, except the
  TP case's aux, whose routing statistics are each chunk's). A rank's
  expert stacks are its block; each MoE layer posts 6 expert all-to-alls
  a microbatch (2 forward, 2 recomputed, 2 transposed).
- The FSDP dims equal JAX ``_moe_fsdp_shard_dims`` on every (data, model,
  expert) size, and a rank's shards JAX's addressable shards
  (``fsdp_shard_params`` on the same mesh shape); the MoE eval under FSDP
  is the oracle's cross entropy within 2e-5.
- MoE x seq x dropout on pipe 2 x model 2 x seq 2: the Ulysses step
  equals the port's own pipe-only step with the same step seed (loss
  1e-5, gradients 2e-5; JAX ``test_moe_pipeline.py:413``, with the port's
  generator convention), the ring's is finite.
- ``fit(moe, zero1=True)`` (AdamW) and ``fit(moe, fsdp=True)`` (SGD) on
  data 2 x pipe 2 x expert 2 within 1e-5 of the same run without them
  (a k bias, whose true gradient is 0, within Adam's 2 lr); killed in a
  save and resumed, each ends bitwise where its unbroken run does; the
  commit holds the whole model and loads into a lockstep ``MoELM``.
- Without the world: a MoE model's Megatron shard of its expert block
  equals the expert block of its shard and ``from_jax_params(...,
  expert=, shard=)``; ZeRO-1's clipping norm counts every block of every
  leaf on exactly one rank (the seq ranks' copies once); the expert ffn
  must divide over the model axis (JAX's message).

Sizes are the JAX tests': gpt2, dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 8, seq 8; weights in the JAX ``moe_lm_init`` layout with
seeded numpy leaves, batches from numpy with a seed.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    moe as jmoe)
from distributed_training_with_pipeline_parallelism_tpu.ops.layers import (
    select_xent as jselect_xent)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    pipeline as jpipe)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    moe as tmoe)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    fsdp as tfsdp, mesh as tmesh, selftest)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.tensor_parallel import (
    shard_model, shard_tensor, split_dim)
from test_torch_moe import _tree as _moe_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S = 8, 8
TOL = 2e-5
SEED = 7  # the dropout cases' step seed
# the MoE configs of the JAX composition tests
MOES = {
    # test_moe_pipeline.py:107, aux on
    "tp": dict(n_experts=4, top_k=2, capacity_factor=4.0,
               aux_loss_weight=0.01),
    # :122
    "ep_tp": dict(n_experts=2, top_k=1, capacity_factor=2.0,
                  aux_loss_weight=0.0),
    # :290-477: zero drops, aux off
    "zd": dict(n_experts=4, top_k=2, capacity_factor=4.0,
               aux_loss_weight=0.0),
}
CFGS = {"base": BASE, "drop": dict(BASE, dropout=0.25)}
# name -> (kind, cfg, moe, schedule, M, (pipe, data, model, seq, expert),
# extra case fields)
CASES = {
    "tp": ("grad", "base", "tp", "1F1B", 2, (2, 2, 2, 1, 1), {}),
    "ep_tp": ("grad", "base", "ep_tp", "GPipe", 2, (2, 1, 2, 1, 2), {}),
    "fsdp": ("grad", "base", "zd", "1F1B", 2, (2, 4, 1, 1, 1),
             dict(fsdp=True)),
    "fsdp_ep": ("grad", "base", "zd", "GPipe", 2, (2, 2, 1, 1, 2),
                dict(fsdp=True)),
    "fsdp_tp": ("grad", "base", "zd", "GPipe", 2, (2, 2, 2, 1, 1),
                dict(fsdp=True)),
    "sp_ring": ("grad", "base", "zd", "GPipe", 2, (2, 2, 1, 2, 1),
                dict(sp_attn_impl="ring")),
    "sp_ulysses": ("grad", "base", "zd", "GPipe", 2, (2, 2, 1, 2, 1),
                   dict(sp_attn_impl="ulysses")),
    "seq_ep": ("grad", "base", "zd", "1F1B", 2, (2, 1, 1, 2, 2), {}),
    "tp_seq": ("grad", "base", "zd", "GPipe", 2, (2, 1, 2, 2, 1), {}),
    "drop_ulysses": ("grad", "drop", "zd", "GPipe", 2, (2, 1, 2, 2, 1),
                     dict(sp_attn_impl="ulysses", seed=SEED)),
    "drop_ring": ("grad", "drop", "zd", "GPipe", 2, (2, 1, 2, 2, 1),
                  dict(sp_attn_impl="ring", seed=SEED)),
    "fsdp_eval": ("eval", "base", "zd", "GPipe", 2, (2, 2, 1, 1, 2),
                  dict(fsdp=True)),
    "zero1_fit": ("moe_fit", "base", "zd", "GPipe", 2, (2, 2, 1, 1, 2),
                  dict(fit_kw=dict(zero1=True), adamw=True)),
    "fsdp_fit": ("moe_fit", "base", "zd", "GPipe", 2, (2, 2, 1, 1, 2),
                 dict(fit_kw=dict(fsdp=True))),
}
ORACLE_CASES = ("tp", "ep_tp", "fsdp", "fsdp_ep", "fsdp_tp", "sp_ring",
                "sp_ulysses", "seq_ep", "tp_seq")
FIT_STEPS = 3
FIT_OPT = dict(learning_rate=1e-3, warmup_steps=0, max_grad_norm=0.1)


def _jcfg(name):
    return dtpp.ModelConfig(**CFGS[name])


def _tcfg(name):
    return port.ModelConfig(**CFGS[name], use_fused_xent=True)


def _tree(moe_name):
    return _moe_tree(_jcfg("base"), jmoe.MoEConfig(**MOES[moe_name]))


def _batch():
    rng = np.random.default_rng(1)
    return tuple(rng.integers(0, 64, (B, S)) for _ in range(2))


def _mesh(name):
    p, d, m, s, e = CASES[name][5]
    return tmesh.Mesh(p, d, 0, "gloo", torch.device("cpu"), n_model=m,
                      n_seq=s, n_expert=e)


class _World:
    """The world's run on a thread of this process, joined on first use."""

    def __init__(self, out):
        self.out = out
        cases = []
        for name, (kind, cfg, moe, sched, M, shape, extra) in CASES.items():
            p, d, m, s, e = shape
            cases.append(dict(
                name=name, kind=kind, cfg=cfg, tree=moe, moe=MOES[moe],
                schedule=sched, M=M, n_pipe=p, n_data=d, n_model=m, n_seq=s,
                n_expert=e, comm_overlap="none", steps=FIT_STEPS, kill=1,
                B=B, S=S, opt=FIT_OPT, **extra))
        tokens, targets = _batch()
        self.spec = dict(
            cfg={}, cfgs={n: dataclasses.asdict(_tcfg(n)) for n in CFGS},
            trees={m: _tree(m) for m in MOES}, tokens=tokens,
            targets=targets, out=str(out), threads=1, cases=cases)
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            self._box["ranks"] = tmesh.launch(
                selftest.run_cases, port.MeshConfig(2, 4), self.spec,
                backend="gloo", device="cpu", timeout_s=240)
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e

    def rank(self, name, r):
        self._thread.join(timeout=500)
        assert not self._thread.is_alive(), "the world did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return dict(np.load(os.path.join(self.out, f"{name}_r{r}.npz")))

    def files(self, name):
        """Each rank's file by (pipe, data, model, seq, expert)."""
        mesh = _mesh(name)
        p, d, m, s, e = CASES[name][5]
        return {c: self.rank(name, mesh.rank_of(c[1], c[0], *c[2:]))
                for c in np.ndindex(p, d, m, s, e)}

    def merged(self, name, key="grad"):
        """(losses, the whole leaves of ``key``, each rank's files): per
        pipe stage, each leaf's blocks concatenated over data along its
        FSDP dim, over model along its Megatron dim and over expert along
        an expert stack's E; equal (to 1e-6) wherever a leaf is
        replicated, the seq ranks' copies included."""
        files = self.files(name)
        p, d, m, s, e = CASES[name][5]
        cfg = _tcfg(CASES[name][1])
        losses, whole = set(), {}

        def one(blocks, dim):
            if dim is not None:
                return torch.cat(blocks, dim=dim)
            for other in blocks[1:]:
                assert torch.allclose(blocks[0], other, atol=1e-6), name
            return blocks[0]

        for pp in range(p):
            z0 = files[pp, 0, 0, 0, 0]
            losses.update(float(z["loss"]) for (q, *_), z in files.items()
                          if q == pp and "loss" in z)
            for n in (n for n in z0 if n.startswith(f"{key}/")):
                leaf = n[len(key) + 1:]
                fd = z0.get(f"fsdp/{leaf}")
                tp_dim = split_dim(cfg, leaf) if m > 1 else None
                ep_dim = 0 if e > 1 and tmoe.is_expert_leaf(leaf) else None
                got = one([one([one([one([
                    torch.from_numpy(files[pp, k, j, q, x][n])
                    for q in range(s)], None) for k in range(d)],
                    None if fd is None else int(fd)) for j in range(m)],
                    tp_dim) for x in range(e)], ep_dim)
                if leaf in whole:
                    assert torch.allclose(whole[leaf], got, atol=1e-6), leaf
                whole.setdefault(leaf, got)
        return losses, whole, files


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(tmp_path_factory.mktemp("moe_par"))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _oracle(moe_name, chunks, M=2):
    """value_and_grad of the mean over ``chunks`` x M equal chunks of the
    batch of ``moe_lm_loss`` (each chunk routes alone)."""
    jcfg, jm = _jcfg("base"), jmoe.MoEConfig(**MOES[moe_name])
    params = jax.tree.map(jnp.asarray, _tree(moe_name))
    tokens, targets = (jnp.asarray(x) for x in _batch())
    toks = tokens.reshape(chunks * M, -1, S)
    tgts = targets.reshape(chunks * M, -1, S)

    def loss(p):
        return jax.vmap(lambda a, b: jmoe.moe_lm_loss(jcfg, jm, p, a, b))(
            toks, tgts).mean()

    return _np(jax.jit(jax.value_and_grad(loss))(params))


def _oracle_key(name):
    """The oracle a grad case is held to: aux off with zero drops makes
    every chunking the same function, so those cases share one."""
    moe = CASES[name][2]
    if MOES[moe]["aux_loss_weight"] == 0.0:
        return moe, 1
    _, _, _, _, _, (_, d, _, _, e), _ = CASES[name]
    return moe, d * e


@pytest.fixture(scope="module")
def refs(world):
    """The JAX oracles (one per MoE config and chunking), compiled here
    while the world runs, and the eval oracle's cross entropy."""
    out = {}
    for name in ORACLE_CASES:
        key = _oracle_key(name)
        if key not in out:
            out[key] = _oracle(*key)
    jcfg, jm = _jcfg("base"), jmoe.MoEConfig(**MOES["zd"])
    params = jax.tree.map(jnp.asarray, _tree("zd"))
    tokens, targets = (jnp.asarray(x) for x in _batch())
    toks, tgts = tokens.reshape(2, -1, S), targets.reshape(2, -1, S)
    out["eval"] = float(sum(jselect_xent(False)(
        jmoe.moe_lm_logits_aux(jcfg, jm, params, toks[m])[0], tgts[m])
        for m in range(2)) / 2)
    return out


def _check(world, name, jloss, jgrads):
    losses, whole, _ = world.merged(name)
    assert len(losses) == 1, (name, losses)
    assert abs(losses.pop() - float(jloss)) < TOL, name
    ref = port.from_jax_params(_tcfg("base"), jgrads, device="cpu",
                               moe=tmoe.MoEConfig(**MOES[CASES[name][2]]))
    assert set(whole) == {n for n, _ in ref.named_parameters()}, name
    worst = max(float((whole[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < TOL, (name, worst)


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_composition_matches_jax_oracle(world, refs, name):
    """Each composition's step against JAX's oracle: the loss on every
    rank and every gradient leaf, merged over the ranks; a rank's expert
    stacks its block; the expert all-to-alls a step."""
    _check(world, name, *refs[_oracle_key(name)])
    _, _, _, M, (p, d, m, s, e), _ = CASES[name][1:]
    lps = BASE["n_layers"] // p
    n_e = MOES[CASES[name][2]]["n_experts"]
    for z in world.files(name).values():
        assert int(z["a2a"]) == (M * lps * 6 if e > 1 else 0), name
        for n in (n for n in z if n.startswith("grad/")):
            if e > 1 and tmoe.is_expert_leaf(n[5:]):
                assert z[n].shape[0] * e == n_e, (name, n)


@pytest.mark.parametrize("n_data,T,n_ep", [
    (2, 1, 1), (2, 1, 2), (2, 2, 1), (4, 1, 1), (2, 2, 2), (8, 1, 1),
    (4, 2, 1), (3, 1, 1)])
def test_moe_fsdp_dims_equal_jax(n_data, T, n_ep):
    """``moe_fsdp_shard_dims`` is JAX ``_moe_fsdp_shard_dims`` leaf for
    leaf, a JAX dim mapped to the port's layout (a linear weight
    transposed; the stacked layer dim dropped)."""
    jcfg, jm = _jcfg("base"), jmoe.MoEConfig(**MOES["zd"])
    jdims = jpipe._moe_fsdp_shard_dims(jcfg, jm, n_data, T, n_ep)
    got = tfsdp.moe_fsdp_shard_dims(_tcfg("base"), tmoe.MoEConfig(
        **MOES["zd"]), n_data, T, n_ep)

    def want(name):
        parts = name.split(".")
        if parts[0] in ("ln1", "ln2"):
            leaf = jdims[parts[0]]["scale" if parts[1] == "weight"
                                   else "bias"]
            return leaf, None
        if parts[0] == "attn":
            leaf = jdims["attn"][parts[1]]["w" if parts[2] == "weight"
                                           else "b"]
            return leaf, {1: 1, 2: 0}
        if parts[1] == "router":
            return jdims["moe"]["router"]["w"], None
        return jdims["moe"][parts[1]], {1: 0, 2: 1, 3: 2}

    assert set(got) == {n for n, _ in tmoe.MoEBlock(
        _tcfg("base"), tmoe.MoEConfig(**MOES["zd"]),
        device="meta").named_parameters()}
    for name, dim in got.items():
        jd, to_port = want(name)
        assert dim == (None if jd < 0 else to_port[jd]), (name, dim, jd)


@pytest.mark.parametrize("name,jax_shape", [
    ("fsdp", None), ("fsdp_ep", (2, 2, 16, 64)), ("fsdp_tp", (2, 2, 32, 32))])
def test_fsdp_shards_are_jax_addressable_shards(world, name, jax_shape):
    """A rank's FSDP shards (its gradients' shapes, and the dims its file
    records) are JAX's addressable shards of ``fsdp_shard_params`` on the
    same mesh shape, a JAX layer shard [L/D, ...] being the port's per
    block (a linear weight transposed); JAX's own test's w1 shapes where
    the meshes agree."""
    jm = jmoe.MoEConfig(**MOES["zd"])
    p, d, m, s, e = CASES[name][5]
    mesh = jax_make_mesh(n_pipe=p, n_data=d, n_model=m, n_expert=e)
    placed = jpipe.fsdp_shard_params(
        jax.tree.map(jnp.asarray, _tree("zd")), _jcfg("base"), mesh, moe=jm)
    layers = placed["layers"]

    def shapes(x):
        return {tuple(sh.data.shape) for sh in x.addressable_shards}

    if jax_shape is not None:
        assert shapes(layers["moe"]["w1"]) == {jax_shape}
    z = world.rank(name, 0)
    for n in (n for n in z if n.startswith("grad/layers.")):
        _, i, *rest = n[5:].split(".")
        if rest[0] == "attn":
            leaf = layers["attn"][rest[1]]["w" if rest[2] == "weight"
                                           else "b"]
            transpose = rest[2] == "weight"
        elif rest[0] == "moe":
            leaf = layers["moe"][rest[1]]
            leaf = leaf["w"] if rest[1] == "router" else leaf
            transpose = False
        else:
            leaf = layers[rest[0]]["scale" if rest[1] == "weight"
                                   else "bias"]
            transpose = False
        (jshape,) = shapes(leaf)
        jshape = jshape[1:][::-1] if transpose else jshape[1:]
        assert tuple(z[n].shape) == jshape, (name, n, z[n].shape, jshape)
    assert any(k.startswith("fsdp/") for k in z), name


def test_fsdp_eval_is_the_oracle_cross_entropy(world, refs):
    """The MoE eval under FSDP x EP (each chunk's matrices gathered just
    in time) reports the oracle's cross entropy on every rank."""
    for r in range(8):
        assert abs(float(world.rank("fsdp_eval", r)["loss"])
                   - refs["eval"]) < TOL


def test_seq_dropout_ulysses_equals_pipe_only(world):
    """MoE x seq x dropout under Ulysses (with TP's head blocks): the
    residual and FFN masks are the unsharded masks' chunks and the
    probabilities' the unsharded ones' head blocks, so the step equals
    the port's pipe-only step with the same step seed."""
    tcfg, tm = _tcfg("drop"), tmoe.MoEConfig(**MOES["zd"])
    whole = port.from_jax_params(tcfg, _tree("zd"), device="cpu", moe=tm)
    tokens, targets = (torch.from_numpy(x) for x in _batch())
    loss = port.make_pipeline_grad_fn(
        tcfg, port.ScheduleConfig("GPipe", 2), 2, device="cpu", moe=tm)(
            whole, tokens, targets, SEED)
    losses, got, _ = world.merged("drop_ulysses")
    assert len(losses) == 1
    assert abs(losses.pop() - float(loss)) < 1e-5
    worst = max(float((got[n] - p.grad).abs().max())
                for n, p in whole.named_parameters())
    assert worst < TOL, worst
    # dropout is on: the eval-mode step differs
    ev = port.make_pipeline_grad_fn(
        _tcfg("base"), port.ScheduleConfig("GPipe", 2), 2, device="cpu",
        moe=tm)(port.from_jax_params(_tcfg("base"), _tree("zd"),
                                     device="cpu", moe=tm), tokens, targets)
    assert abs(float(ev) - float(loss)) > 1e-6


def test_seq_dropout_ring_is_finite(world):
    losses, got, _ = world.merged("drop_ring")
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert all(torch.isfinite(g).all() for g in got.values())


def _fit_files(world, name):
    return world.files(name)


@pytest.mark.parametrize("name", ["zero1_fit", "fsdp_fit"])
def test_fit_composed_matches_plain_run(world, name):
    """``fit(moe)`` with ZeRO-1 (AdamW) or FSDP (SGD) ends within 1e-5 of
    the same world's run without it: FSDP's params are the plain ones'
    shards; a k bias's true gradient is 0, so Adam moves it by up to lr a
    step on rounding noise."""
    d = CASES[name][5][1]
    for (_, k, *_), z in _fit_files(world, name).items():
        for key in (n for n in z if n.startswith("par/param/")):
            n = key[len("par/param/"):]
            want = torch.from_numpy(z[f"plain/param/{n}"])
            fd = z.get(f"fsdp/{n}")
            if fd is not None:
                want = shard_tensor(want, int(fd), d, k)
            tol = (2 * FIT_OPT["learning_rate"]
                   if name == "zero1_fit" and n.endswith("attn.k.bias")
                   else 1e-5)
            got = torch.from_numpy(z[key])
            assert got.shape == want.shape, (name, n)
            assert float((got - want).abs().max()) <= tol, (name, n)


@pytest.mark.parametrize("name", ["zero1_fit", "fsdp_fit"])
def test_fit_composed_resumes_bitwise(world, name):
    for z in _fit_files(world, name).values():
        for key in (n for n in z if n.startswith("par/param/")):
            n = key[len("par/param/"):]
            assert np.array_equal(z[key], z[f"resumed/param/{n}"]), (name, n)


@pytest.mark.parametrize("name", ["zero1_fit", "fsdp_fit"])
def test_fit_composed_commit_loads_into_lockstep_model(world, name):
    """The last step dir holds the whole model (the expert stacks gathered,
    FSDP's shards concatenated): a lockstep ``MoELM`` loads it, and each
    rank's final params are its cut of it."""
    tcfg, tm = _tcfg("base"), tmoe.MoEConfig(**MOES["zd"])
    files = _fit_files(world, name)
    saved = {k[6:]: torch.from_numpy(v)
             for k, v in files[0, 0, 0, 0, 0].items()
             if k.startswith("whole/")}
    lock = tmoe.MoELM(tcfg, tm, device="cpu")
    lock.load_state_dict(saved)
    _, d, _, _, e = CASES[name][5]
    for (_, k, _, _, x), z in files.items():
        for key in (n for n in z if n.startswith("resumed/param/")):
            n = key[len("resumed/param/"):]
            want = tmoe.expert_block(n, saved[n], (e, x))
            fd = z.get(f"fsdp/{n}")
            if fd is not None:
                want = shard_tensor(want, int(fd), d, k)
            assert torch.equal(torch.from_numpy(z[key]), want), (name, n)


def test_model_shard_composes_with_expert_block():
    """``shard_model`` of a MoE model's expert block (the order a world
    cuts them) equals the expert block of its Megatron shard, and
    ``from_jax_params(..., moe=, expert=, shard=)`` gives the same
    leaves; the Megatron dims are JAX ``_moe_layer_specs``' (w1, b1, w2 on
    the expert ffn; the router and b2 replicated)."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.expert_parallel import (
        ep_shard_model)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.tensor_parallel import (
        TPShard, gather_model)
    tcfg, tm = _tcfg("base"), tmoe.MoEConfig(**MOES["zd"])
    whole = port.from_jax_params(tcfg, _tree("zd"), device="cpu", moe=tm)
    ep = _mesh("ep_tp")
    shards = []
    for j in range(2):
        a = shard_model(ep_shard_model(whole, ep), tcfg, n=2, index=j)
        b = ep_shard_model(shard_model(whole, tcfg, n=2, index=j), ep)
        c = port.from_jax_params(tcfg, _tree("zd"), device="cpu", moe=tm,
                                 expert=(2, 0), shard=TPShard(2, j))
        for x, y in ((a, b), (a, c)):
            sx, sy = x.state_dict(), y.state_dict()
            assert all(torch.equal(sx[k], sy[k]) for k in sx)
        shards.append(a)
    st = shards[0].state_dict()
    assert st["layers.0.moe.w1"].shape == (2, 32, 32)
    assert st["layers.0.moe.b1"].shape == (2, 32)
    assert st["layers.0.moe.w2"].shape == (2, 32, 32)
    assert st["layers.0.moe.b2"].shape == (2, 32)
    assert st["layers.0.moe.router"].shape == (32, 4)
    back = gather_model(shards, tcfg)
    want = tmoe.expert_block
    for k, v in back.items():
        assert torch.equal(v, want(k, whole.state_dict()[k], (2, 0))), k


@pytest.mark.parametrize("shape", [(2, 2, 1, 2, 2), (2, 2, 2, 1, 2),
                                   (2, 2, 1, 2, 1)])
def test_zero1_norm_counts_each_block_once(shape):
    """ZeRO-1's clipping norm sums each leaf's squares over the whole
    world: every data block of every leaf (a Megatron shard's, an expert
    block's) is counted on exactly one rank, the seq ranks holding the
    same blocks included."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.expert_parallel import (
        ep_shard_model)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.train import (
        ShardedAdamWState, adamw)
    p, d, m, s, e = shape
    tcfg, tm = _tcfg("base"), tmoe.MoEConfig(**MOES["zd"])
    counts = {}
    for r in range(p * d * m * s * e):
        mesh = tmesh.Mesh(p, d, r, "gloo", torch.device("cpu"), n_model=m,
                          n_seq=s, n_expert=e)
        model = tmoe.MoELM(tcfg, tm, device="cpu", layers=port.owned_layers(
            tcfg.n_layers, port.ScheduleConfig("GPipe", 2), p, mesh.pipe))
        model = ep_shard_model(model, mesh) if e > 1 else model
        model = shard_model(model, tcfg, mesh) if m > 1 else model
        state = ShardedAdamWState(adamw(), model, mesh)
        for name, counted in zip(state.names, state._counted):
            key = (name, mesh.data,
                   mesh.model if m > 1 and split_dim(tcfg, name) is not None
                   else None,
                   mesh.expert if tmoe.is_expert_leaf(name) else None)
            counts[key] = counts.get(key, 0) + int(counted)
    assert set(counts.values()) == {1}, {k: v for k, v in counts.items()
                                         if v != 1}


@pytest.mark.parametrize("build", [
    lambda c, m: port.make_pipeline_grad_fn(
        c, port.ScheduleConfig("GPipe", 2), 2, device="cpu",
        moe=dataclasses.replace(m, ffn_dim=30),
        mesh=tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_model=4)),
    lambda c, m: port.make_pipeline_loss_fn(
        c, port.ScheduleConfig("GPipe", 2), 2, device="cpu",
        moe=dataclasses.replace(m, ffn_dim=30),
        mesh=tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_model=4)),
    lambda c, m: shard_model(tmoe.MoELM(
        c, dataclasses.replace(m, ffn_dim=30), device="cpu"), c, n=4,
        index=0),
])
def test_expert_ffn_must_divide_over_the_model_axis(build):
    """JAX ``_check_moe_mesh``'s TP rule, word for word."""
    tcfg, tm = _tcfg("base"), tmoe.MoEConfig(**MOES["zd"])
    with pytest.raises(ValueError, match="MoE expert ffn_dim=30 must be "
                       "divisible by the model-axis size 4"):
        build(tcfg, tm)
