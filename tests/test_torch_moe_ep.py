"""Expert parallelism in the port's ``torch.distributed`` world on the CPU,
held to the JAX package's ``parallel/expert_parallel.py`` and MoE pipeline
on the simulated 8-device mesh.

One gloo world of 8 ranks (``parallel.selftest.run_cases`` under
``parallel.mesh.launch``; the children import neither jax nor this
module) runs every case on a thread while the JAX references compile
here:

- ``make_ep_loss_fn`` on an expert-only world of 8 against JAX's
  ``make_ep_loss_fn`` and the unsharded ``moe_lm_loss`` (zero drops, aux
  off; ``test_moe.py:98,108``): loss 1e-5, gradients 2e-5, each rank's
  expert-stack gradients JAX's block of them (``test_moe.py:123``).
- pp x ep (pipe 2 x expert 4, 1F1B) against JAX's ``make_pipeline_step``
  on the same mesh and the microbatched oracle (``test_moe_pipeline.py:
  68``); dp x ep (pipe 2 x data 2 x expert 2, GPipe, ``:82``); the aux loss
  on, against JAX's chunked oracle (each (expert shard, microbatch) chunk
  routes alone, ``:155``); ``pad_token_id`` over the expert axis
  (``test_padding.py:188``): loss 1e-5, gradients 2e-5. A rank's expert
  stacks hold 1/n_expert of its stage's, and each MoE layer posts two
  all-to-alls a unit.
- The EP eval (``make_pipeline_loss_fn(moe=)``, pipe 2 x expert 4): the
  cross entropy only, within 2e-5 of JAX's CE oracle
  (``test_eval.py:196``).
- ``fit(moe=)`` on pipe 2 x data 2 x expert 2 with SGD for 4 steps from a
  whole view (``fit`` cuts the rank's experts): within 1e-5 of the
  lockstep ``fit``; killed in a save and resumed, it ends bitwise where the
  unbroken run does; the committed step dir holds the whole expert stacks
  and loads into a lockstep model (``restore_world_model``). Two clipped
  AdamW updates (shard-shaped moments, the world's clipping norm) within
  1e-5 of the lockstep ``fit``'s (the k biases, whose true gradient is 0,
  within Adam's 2 lr).

Sizes are the JAX tests': gpt2, dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 8, seq 8 (the EP loss: 2 layers, 2 heads, E = 8, batch 8 x
16); weights in the JAX ``moe_lm_init`` layout with seeded numpy leaves,
batches from numpy with a seed.
"""

import copy
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
    masked_xent_sum as jmasked_xent_sum, select_xent as jselect_xent)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    expert_parallel as jep, pipeline as jpipe)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_ep_mesh, make_mesh as jax_make_mesh)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    moe as tmoe)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, selftest)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    data as tdata, train as ttrain)
from test_torch_moe import _tree as _moe_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
EP_BASE = dict(dim=32, n_layers=2, n_heads=2, vocab_size=64, ffn_dim=64,
               max_seq_len=32, arch="gpt2")
B, S, PAD = 8, 8, 0
TOL = 2e-5
# the MoE configs of the JAX tests
MOES = {
    "ep": dict(n_experts=8, top_k=2, capacity_factor=8.0,
               aux_loss_weight=0.0, ffn_dim=32),
    "pp_ep": dict(n_experts=4, top_k=2, capacity_factor=4.0,
                  aux_loss_weight=0.0),
    "dp_ep": dict(n_experts=4, top_k=1, capacity_factor=4.0,
                  aux_loss_weight=0.0),
    "aux": dict(n_experts=4, top_k=2, capacity_factor=4.0,
                aux_loss_weight=0.05),
    "eval": dict(n_experts=4, top_k=2, capacity_factor=4.0,
                 aux_loss_weight=0.01),
    "pad": dict(n_experts=4, top_k=2, capacity_factor=8.0,
                aux_loss_weight=0.0),
}
# name -> (kind, cfg, moe, batch, schedule, M, (pipe, data, expert))
CASES = {
    "ep_loss": ("ep_loss", "ep", "ep", "ep", "GPipe", 1, (1, 1, 8)),
    "pp_ep": ("grad", "base", "pp_ep", "main", "1F1B", 2, (2, 1, 4)),
    "dp_ep": ("grad", "base", "dp_ep", "main", "GPipe", 2, (2, 2, 2)),
    "pp_ep_aux": ("grad", "base", "aux", "main", "GPipe", 2, (2, 1, 4)),
    "pp_ep_pad": ("grad", "pad", "pad", "pad", "GPipe", 2, (2, 1, 4)),
    "ep_eval": ("eval", "base", "eval", "main", "GPipe", 2, (2, 1, 4)),
    "fit": ("moe_fit", "base", "pp_ep", "main", "GPipe", 2, (2, 2, 2)),
}
FIT_STEPS = 4
# 2 clipped AdamW updates of the fit case (the clipping norm sums the
# expert stacks' squares over the expert group)
FIT_OPT = dict(learning_rate=1e-3, warmup_steps=0, max_grad_norm=0.1)


def _cfg_fields(name):
    base = EP_BASE if name == "ep" else BASE
    extra = dict(pad_token_id=PAD) if name == "pad" else {}
    return dict(base, **extra)


def _jcfg(name):
    return dtpp.ModelConfig(**_cfg_fields(name))


def _tcfg(name):
    return port.ModelConfig(**_cfg_fields(name), use_fused_xent=True)


def _tree(cfg_name, moe_name):
    return _moe_tree(_jcfg(cfg_name), jmoe.MoEConfig(**MOES[moe_name]))


def _batches():
    rng = np.random.default_rng(1)
    main = tuple(rng.integers(0, 64, (B, S)) for _ in range(2))
    ep = tuple(rng.integers(0, 64, (B, 16)) for _ in range(2))
    pad = (rng.integers(1, 64, (B, S)), rng.integers(1, 64, (B, S)))
    for i, keep in enumerate([2, 6, 3, 5, 4, 6, 2, 5]):
        pad[1][i, keep:] = PAD
    return {"main": main, "ep": ep, "pad": pad}


class _World:
    """The world's run on a thread of this process, joined on first use."""

    def __init__(self, out):
        self.out = out
        cases = []
        for name, (kind, cfg, moe, batch, sched, M, (p, d, e)) in \
                CASES.items():
            cases.append(dict(
                name=name, kind=kind, cfg=cfg, tree=f"{cfg}_{moe}",
                moe=MOES[moe], batch=batch, schedule=sched, M=M, n_pipe=p,
                n_data=d, n_expert=e, comm_overlap="none", steps=FIT_STEPS,
                kill=2, B=B, S=S, opt=FIT_OPT))
        self.spec = dict(
            cfg={}, cfgs={n: dataclasses.asdict(_tcfg(n))
                          for n in ("base", "ep", "pad")},
            trees={c["tree"]: _tree(c["cfg"], m) for c, m in
                   zip(cases, [v[2] for v in CASES.values()])},
            batches=_batches(), tokens=None, targets=None, out=str(out),
            threads=1, cases=cases)
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            self._box["ranks"] = tmesh.launch(
                selftest.run_cases, port.MeshConfig(2, 1, 1, 1, 4), self.spec,
                backend="gloo", device="cpu", timeout_s=180)
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e

    def rank(self, name, r):
        self._thread.join(timeout=400)
        assert not self._thread.is_alive(), "the world did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return dict(np.load(os.path.join(self.out, f"{name}_r{r}.npz")))

    def merged(self, name):
        """(losses, whole gradients, each rank's files) of a case: each
        stage's expert blocks concatenated in expert order, every other
        leaf equal on every rank that holds it."""
        p, d, e = CASES[name][6]
        mesh = tmesh.Mesh(p, d, 0, "gloo", torch.device("cpu"), n_expert=e)
        losses, whole, files = set(), {}, {}
        for pp in range(p):
            zs = {(k, x): self.rank(name, mesh.rank_of(k, pp, expert=x))
                  for k in range(d) for x in range(e)}
            files[pp] = zs
            losses.update(float(z["loss"]) for z in zs.values())
            for n in (n for n in zs[0, 0] if n.startswith("grad/")):
                leaf = n[5:]
                for k in range(d):
                    blocks = [torch.from_numpy(zs[k, x][n]) for x in range(e)]
                    if tmoe.is_expert_leaf(leaf):
                        got = torch.cat(blocks)
                    else:
                        for other in blocks[1:]:
                            assert torch.equal(blocks[0], other), (name,
                                                                   leaf)
                        got = blocks[0]
                    if leaf in whole and not leaf.startswith("layers."):
                        assert torch.allclose(whole[leaf], got, atol=1e-7)
                    whole.setdefault(leaf, got)
        return losses, whole, files


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(tmp_path_factory.mktemp("moe_ep"))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _oracle(name, chunks=1):
    """value_and_grad of the mean over (expert shard, microbatch) chunks of
    ``moe_lm_loss`` (``chunks`` expert shards; each chunk routes alone)."""
    kind, cfg, moe, batch, _, M, _ = CASES[name]
    jcfg, jm = _jcfg(cfg), jmoe.MoEConfig(**MOES[moe])
    params = jax.tree.map(jnp.asarray, _tree(cfg, moe))
    tokens, targets = (jnp.asarray(x) for x in _batches()[batch])
    toks = tokens.reshape(chunks * M, -1, tokens.shape[1])
    tgts = targets.reshape(chunks * M, -1, tokens.shape[1])

    def loss(p):
        return jax.vmap(lambda a, b: jmoe.moe_lm_loss(jcfg, jm, p, a, b))(
            toks, tgts).mean()

    return _np(jax.jit(jax.value_and_grad(loss))(params))


def _check(world, name, jloss, jgrads, loss_tol=1e-5):
    kind, cfg, moe, *_ = CASES[name]
    losses, whole, _ = world.merged(name)
    assert len(losses) == 1, (name, losses)
    assert abs(losses.pop() - float(jloss)) < loss_tol, name
    ref = port.from_jax_params(_tcfg(cfg), jgrads, device="cpu",
                               moe=tmoe.MoEConfig(**MOES[moe]))
    assert set(whole) == {n for n, _ in ref.named_parameters()}, name
    worst = max(float((whole[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < TOL, (name, worst)


def _pad_oracle():
    """``test_padding.py:188``'s masked CE over the expert axis (aux off):
    the global masked mean of the unsharded model."""
    jcfg, jm = _jcfg("pad"), jmoe.MoEConfig(**MOES["pad"])
    params = jax.tree.map(jnp.asarray, _tree("pad", "pad"))
    tokens, targets = (jnp.asarray(x) for x in _batches()["pad"])

    def oracle(p):
        def one(a, b):
            logits, _ = jmoe.moe_lm_logits_aux(jcfg, jm, p, a)
            return jmasked_xent_sum(logits, b, PAD)

        s, n = jax.vmap(one)(tokens.reshape(8, -1, S),
                             targets.reshape(8, -1, S))
        return s.sum() / n.sum()

    return _np(jax.jit(jax.value_and_grad(oracle))(params))


def _eval_oracle():
    """The CE term of the microbatched oracle (``test_eval.py:196``)."""
    jcfg, jm = _jcfg("base"), jmoe.MoEConfig(**MOES["eval"])
    params = jax.tree.map(jnp.asarray, _tree("base", "eval"))
    tokens, targets = (jnp.asarray(x) for x in _batches()["main"])
    toks, tgts = tokens.reshape(2, -1, S), targets.reshape(2, -1, S)
    return float(sum(jselect_xent(False)(
        jmoe.moe_lm_logits_aux(jcfg, jm, params, toks[m])[0], tgts[m])
        for m in range(2)) / 2)


@pytest.fixture(scope="module")
def refs(world):
    """The JAX references, compiled here while the world runs: JAX's
    ``make_ep_loss_fn`` and dense loss, its pp x ep executor, the
    microbatched and chunked oracles, the masked oracle, the eval's CE."""
    out = {}
    jcfg, jm = _jcfg("ep"), jmoe.MoEConfig(**MOES["ep"])
    params = jax.tree.map(jnp.asarray, _tree("ep", "ep"))
    tokens, targets = _batches()["ep"]
    loss_fn = jep.make_ep_loss_fn(jcfg, jm, make_ep_mesh(8))
    out["ep_loss"] = _np(jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, tokens, targets)))(params))
    out["ep_dense"] = float(jmoe.moe_lm_loss(jcfg, jm, params, tokens,
                                             targets))
    jm = jmoe.MoEConfig(**MOES["pp_ep"])
    step = jpipe.make_pipeline_step(_jcfg("base"),
                                    jax_make_mesh(n_pipe=2, n_expert=4),
                                    dtpp.ScheduleConfig("1F1B", 2), moe=jm)
    out["pp_ep_step"] = _np(step(jax.tree.map(
        jnp.asarray, _tree("base", "pp_ep")), *_batches()["main"]))
    for name, chunks in (("pp_ep", 1), ("dp_ep", 1), ("pp_ep_aux", 4)):
        out[name] = _oracle(name, chunks)
    out["pp_ep_pad"] = _pad_oracle()
    out["ep_eval"] = _eval_oracle()
    return out


def test_ep_loss_matches_jax(world, refs):
    jloss, jgrads = refs["ep_loss"]
    assert abs(float(jloss) - refs["ep_dense"]) < 1e-5
    _check(world, "ep_loss", jloss, jgrads)
    # rank e's expert stacks' gradients are JAX's block e
    g_w1 = np.asarray(jgrads["layers"]["moe"]["w1"])  # [L, E, d, f]
    for e in range(8):
        got = world.rank("ep_loss", e)["grad/layers.1.moe.w1"]
        assert np.abs(got - g_w1[1, e:e + 1]).max() < TOL


def test_pp_ep_matches_jax_step(world, refs):
    """pp x ep: JAX's executor on the same (pipe 2, expert 4) mesh and its
    microbatched oracle; each MoE layer posts 2 all-to-alls in the forward
    unit and 4 in the recomputing backward (2 recomputed, 2 transposed)."""
    _check(world, "pp_ep", *refs["pp_ep_step"])
    _check(world, "pp_ep", *refs["pp_ep"])
    M, lps = 2, 2
    for z in world.merged("pp_ep")[2][0].values():
        assert int(z["a2a"]) == M * lps * 6


def test_dp_ep_matches_jax(world, refs):
    _check(world, "dp_ep", *refs["dp_ep"])


def test_pp_ep_aux_on_matches_jax_chunked_oracle(world, refs):
    _check(world, "pp_ep_aux", *refs["pp_ep_aux"])


def test_pp_ep_padded_matches_jax(world, refs):
    """The valid count sums over the expert axis (a batch axis): the CE is
    the global masked mean."""
    _check(world, "pp_ep_pad", *refs["pp_ep_pad"])


def test_expert_shard_residency(world):
    """A rank's expert stacks (and their gradients) are 1/n_expert of its
    stage's."""
    for name in ("pp_ep", "dp_ep"):
        e = CASES[name][6][2]
        z = world.rank(name, 0)
        ref = port.from_jax_params(_tcfg("base"), _tree("base", name),
                                   device="cpu",
                                   moe=tmoe.MoEConfig(**MOES[name]),
                                   layers=[0, 1])
        for n, p in ref.named_parameters():
            if tmoe.is_expert_leaf(n):
                assert z[f"grad/{n}"].size * e == p.numel(), (name, n)


def test_ep_eval_is_cross_entropy_only(world, refs):
    ref = refs["ep_eval"]
    for r in range(8):
        assert abs(float(world.rank("ep_eval", r)["loss"]) - ref) < TOL


def test_fit_moe_ep_matches_lockstep_and_resumes(world):
    tcfg, tm = _tcfg("base"), tmoe.MoEConfig(**MOES["pp_ep"])
    whole = port.from_jax_params(tcfg, _tree("base", "pp_ep"), device="cpu",
                                 moe=tm)
    data = tdata.synthetic_batches(tcfg.vocab_size, B, S, seed=1)
    ref, _ = ttrain.fit(tcfg, port.ScheduleConfig("GPipe", 8), 2,
                        copy.deepcopy(whole), data, FIT_STEPS,
                        optimizer=ttrain.sgd(0.1), verbose=False,
                        device="cpu", moe=tm)
    data = tdata.synthetic_batches(tcfg.vocab_size, B, S, seed=1)
    ref_adamw, _ = ttrain.fit(tcfg, port.ScheduleConfig("GPipe", 8), 2,
                              copy.deepcopy(whole), data, 2,
                              optimizer=ttrain.adamw(**FIT_OPT),
                              verbose=False, device="cpu", moe=tm)
    want_adamw = dict(ref_adamw.named_parameters())
    p, d, e = CASES["fit"][6]
    mesh = tmesh.Mesh(p, d, 0, "gloo", torch.device("cpu"), n_expert=e)
    want = dict(ref.named_parameters())
    for pp in range(p):
        for k in range(d):
            for x in range(e):
                z = world.rank("fit", mesh.rank_of(k, pp, expert=x))
                for n in (n[12:] for n in z if n.startswith("plain/")):
                    got = torch.from_numpy(z[f"plain/param/{n}"])
                    w = tmoe.expert_block(n, want[n].detach(), (e, x))
                    assert float((got - w).abs().max()) < 1e-5, n
                    assert np.array_equal(z[f"plain/param/{n}"],
                                          z[f"resumed/param/{n}"]), n
                    # AdamW: shard-shaped moments, the world's clipping
                    # norm; a k bias's true gradient is 0 (softmax is
                    # shift-invariant), so Adam moves it by up to lr a step
                    # on rounding noise
                    got = torch.from_numpy(z[f"adamw/param/{n}"])
                    w = tmoe.expert_block(n, want_adamw[n].detach(), (e, x))
                    tol = (2 * FIT_OPT["learning_rate"]
                           if n.endswith("attn.k.bias") else 1e-5)
                    assert float((got - w).abs().max()) <= tol, n
    # the step dir holds the whole expert stacks: a lockstep model loads it
    saved = {k[6:]: torch.from_numpy(v)
             for k, v in world.rank("fit", 0).items()
             if k.startswith("whole/")}
    lock = tmoe.moe_init_params(tcfg, tm, torch.Generator().manual_seed(0),
                                device="cpu")
    lock.load_state_dict(saved)
    for n, w in want.items():
        assert float((dict(lock.named_parameters())[n] - w).abs().max()) \
            < 1e-5, n
