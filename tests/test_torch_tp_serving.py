"""Tensor parallelism in the port's pipelined decoder and serving engine on
the CPU, held to the JAX package.

One gloo world of shape (pipe 1, data 1, model 2)
(``parallel.selftest.run_cases`` under ``parallel.mesh.launch``, so the
children import neither jax nor this module) runs every decode and serve
case, each rank on its ``shard_model`` shard with D = 2 lockstep stages,
in a thread of one test, while the JAX references compile there (one
test, so one world however the suite's workers split the file). The JAX
side runs its pipe 2 x model 2 mesh, whose pipe axis the port keeps as
its lockstep stages and whose model axis becomes the ranks:

- the decoder (gpt2, llama with 2 kv heads, tied llama): greedy tokens
  exactly the jitted JAX ``generate``'s and the JAX
  ``make_pipeline_generate_fn``'s on the mesh, on both ranks;
  ``return_logprobs`` (the replicated head) within 1e-5 of JAX
  ``generate``'s; sampling in the vocabulary and the same on both ranks;
- the engine (llama): contiguous completions (tokens and tick stamps)
  exactly the JAX engine's on the mesh and the port's T = 1 engine's;
  paged (pages of 4) equal to contiguous, speculative (the model as its
  own draft, whole on every rank, gamma 2) equal to plain;
- the vocab-parallel head's first-max tie-break, on ranks that are
  threads;
- the refusals: a data, seq or expert axis, heads that do not divide over
  the model axis, and log-probs with the vocab-parallel head carry the
  JAX messages; a pipe axis above 1 carries the port's, naming
  ``ROADMAP.md``.

Sizes are the JAX tests' ``_cfg``: dim 32, 4 layers, 4 heads, vocab 64,
ffn 64; weights and prompts from numpy with a seed.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models.generate import (
    make_generate_fn as jgenerate_fn)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jmake_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    pipelined_decode as jpd)
from distributed_training_with_pipeline_parallelism_tpu.serving import (
    engine as jeng)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    head_apply)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, pipelined_decode as tpd, selftest)
from test_torch_tp import _numpy_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=64)
ARCHS = {"gpt2": dict(arch="gpt2"),
         "llama": dict(arch="llama", n_kv_heads=2),
         "llama_tied": dict(arch="llama", n_kv_heads=2, tie_embeddings=True)}
B, P, N, M, D = 4, 5, 6, 2, 2
LP_TOL = 1e-5
EOS = 5
PROGRAM = dict(n_slots=2, max_len=20, prompt_max=6, out_max=6,
               prefill_chunk=3, eos_id=EOS)
WORLD = dict(n_pipe=1, n_data=1, n_model=2, n_stages=D)


def _cfgs():
    return {a: dict(BASE, **kw) for a, kw in ARCHS.items()}


def _jax_cfg(arch):
    return dtpp.ModelConfig(**_cfgs()[arch])


def _prompt():
    return np.random.default_rng(1).integers(0, BASE["vocab_size"], (B, P))


def _requests():
    """(rid, prompt, budget, arrival) rows: prompts of 1-6 in-vocab tokens,
    budgets of 1-6, one arrival a tick (the JAX paged TP test's trace)."""
    rng = np.random.RandomState(2)
    return [(i, [int(t) for t in rng.randint(1, BASE["vocab_size"],
                                             size=rng.randint(1, 7))],
             int(rng.randint(1, 7)), float(i)) for i in range(5)]


def _cases():
    cases = [dict(name=f"dec_{a}", kind="decode", cfg=a, tree=a, N=N,
                  prompt="p", decode=dict(n_streams=M), **WORLD)
             for a in ARCHS]
    cases.append(dict(name="dec_lp", kind="decode", cfg="llama",
                      tree="llama", N=N, prompt="p",
                      decode=dict(n_streams=M, return_logprobs=True),
                      **WORLD))
    cases.append(dict(name="dec_sample", kind="decode", cfg="gpt2",
                      tree="gpt2", N=4, prompt="p", seed=3,
                      decode=dict(n_streams=M, temperature=0.7, top_p=0.9),
                      **WORLD))
    for mode, extra in (("contiguous", {}),
                        ("paged", dict(paged=True, page_size=4)),
                        ("spec", dict(gamma=2))):
        case = dict(name=f"serve_{mode}", kind="serve", cfg="llama",
                    tree="llama", program=dict(PROGRAM, **extra),
                    requests="r", **WORLD)
        if mode == "spec":
            case.update(draft_cfg="llama", draft_tree="llama")
        cases.append(case)
    return cases


def _launch(spec, box):
    """The world's run (on a thread of the test)."""
    try:
        t = time.perf_counter()
        box["ranks"] = tmesh.launch(selftest.run_cases,
                                    port.MeshConfig(1, 1, 2), spec,
                                    backend="gloo", device="cpu",
                                    timeout_s=120)
        box["seconds"] = time.perf_counter() - t
    except BaseException as e:  # re-raised on the test's thread
        box["error"] = e


def _completions(res):
    return [(c.rid, [int(t) for t in c.tokens], c.slot, c.first_token_tick,
             c.finish_tick, c.status) for c in res.completions]


def test_tp_world_matches_jax():
    """One world for every case (one test, so one world however the
    suite's workers split the file), the JAX side compiling meanwhile:

    - greedy decode (kv-head shards, the vocab-parallel head: 64 divides
      over 2), each arch on both ranks: exactly the jitted JAX
      ``generate``'s tokens and the JAX decoder's on pipe 2 x model 2;
    - ``return_logprobs`` (the replicated head): tokens exactly, log-probs
      within 1e-5 of JAX ``generate``'s;
    - sampling (temperature 0.7, top-p 0.9, each rank's generator seeded
      alike): in the vocabulary, the prompt kept, the same on both ranks;
    - the contiguous engine: completions (tokens, slots, tick stamps) on
      both ranks exactly the JAX engine's on pipe 2 x model 2 and the
      port's T = 1 engine's; no CUDA graphs in a staging-free CPU world;
    - paged (pages of 4, the pool holding a rank's kv-head shard): the
      contiguous TP completions and the port's T = 1 paged engine's;
    - speculative (gamma 2, the model its own draft, whole on every rank,
      the verify head vocab-parallel per row): each request's tokens
      those of the plain TP engine, with drafts accepted."""
    trees = {a: _numpy_tree(_jax_cfg(a), 0) for a in ARCHS}
    box = {}
    world = threading.Thread(target=_launch, args=(dict(
        cfgs=_cfgs(), trees=trees, prompts={"p": _prompt()},
        requests={"r": _requests()}, threads=1, cases=_cases()), box))
    world.start()
    try:
        params = {a: jax.tree.map(jnp.asarray, t) for a, t in trees.items()}
        prompt = _prompt()
        jmesh = jmake_mesh(n_pipe=2, n_model=2)
        want = {}
        for a in ARCHS:
            want[a] = np.asarray(jgenerate_fn(_jax_cfg(a), N)(params[a],
                                                              prompt))
            mesh_gen = jpd.make_pipeline_generate_fn(_jax_cfg(a), jmesh, N,
                                                     n_streams=M)
            assert np.array_equal(np.asarray(mesh_gen(params[a], prompt)),
                                  want[a]), a
        want_lp = [np.asarray(x) for x in jgenerate_fn(
            _jax_cfg("llama"), N, return_logprobs=True)(params["llama"],
                                                        prompt)]
        program = jeng.make_serving_step_fn(_jax_cfg("llama"), jmesh,
                                            **PROGRAM)
        want_serve = _completions(jeng.ServingEngine(
            program, params["llama"]).run([jeng.Request(*r)
                                           for r in _requests()]))
        tcfg = port.ModelConfig(**_cfgs()["llama"])
        model = port.from_jax_params(tcfg, trees["llama"], device="cpu")
        t1 = {}
        for mode, extra in (("contiguous", {}),
                            ("paged", dict(paged=True, page_size=4))):
            t1[mode] = _completions(port.ServingEngine(
                port.make_serving_step_fn(tcfg, D, device="cpu", **PROGRAM,
                                          **extra), model).run(
                [port.Request(*r) for r in _requests()]))
        assert t1["contiguous"] == want_serve
    finally:
        world.join(timeout=300)
    assert not world.is_alive(), "the world did not finish"
    if "error" in box:
        raise box["error"]

    def case(name):
        return [r["cases"][name] for r in box["ranks"]]

    for a in ARCHS:
        for info in case(f"dec_{a}"):
            got, = info["outputs"]
            assert np.array_equal(got, want[a]), (a, got.tolist())
    for info in case("dec_lp"):
        got, lp = info["outputs"]
        assert np.array_equal(got, want_lp[0])
        assert np.abs(lp - want_lp[1]).max() < LP_TOL
    samples = [info["outputs"][0] for info in case("dec_sample")]
    assert samples[0].shape == (B, P + 4)
    assert np.array_equal(samples[0][:, :P], prompt)
    assert ((samples[0] >= 0) & (samples[0] < BASE["vocab_size"])).all()
    assert np.array_equal(samples[0], samples[1])
    for info in case("serve_contiguous"):
        assert [tuple(c) for c in info["completions"]] == want_serve
        assert info["cuda_graphs"] is False
    for info in case("serve_paged"):
        assert [tuple(c) for c in info["completions"]] == t1["paged"]
        assert [c[:2] for c in info["completions"]] == \
            [c[:2] for c in want_serve]
    plain = {c[0]: c[1] for c in want_serve}
    for info in case("serve_spec"):
        assert {c[0]: list(c[1]) for c in info["completions"]} == plain
        assert info["acceptance_rate"] > 0


class _Threads:
    """A model group of ``T`` ranks as threads of this process: each
    rank's mesh gathers over a barrier, enough for the vocab-parallel
    head's one collective."""

    def __init__(self, T):
        self.T, self.parts = T, [None] * T
        self.barrier = threading.Barrier(T, timeout=60)

    def mesh(self, t):
        group = self

        class _Mesh:
            n_model, model = group.T, t

            def __init__(self):
                self.tp_stats = {}

            def all_gather(self, out, shard, axis):
                group.parts[t] = shard.clone()
                group.barrier.wait()
                out.copy_(torch.cat(group.parts))
                group.barrier.wait()

        return _Mesh()


def _vocab_parallel_on_threads(cfg, model, y, T):
    group, got = _Threads(T), [None] * T

    def rank(t):
        got[t] = tpd.vocab_parallel_greedy(cfg, model, y, group.mesh(t))

    threads = [threading.Thread(target=rank, args=(t,)) for t in range(T)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads), "a rank hung"
    return got


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("T", [2, 4])
def test_vocab_parallel_greedy_first_max_wins(T, tied):
    """The vocab-parallel head on T ranks gives the replicated head's
    ``argmax`` on every rank; and where the head (or the tied token
    table) repeats its first V/T rows T times, so that every maximum
    lies in every rank's block, the first copy, the lowest index, wins
    (JAX's tie-break)."""
    V = 16
    cfg = port.ModelConfig(**dict(
        _cfgs()["llama_tied" if tied else "llama"], vocab_size=V))
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = model.tok if tied else model.out.weight
    y = torch.randn(6, cfg.dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = torch.argmax(head_apply(cfg, model, y), dim=-1)
        got = _vocab_parallel_on_threads(cfg, model, y, T)
        assert all(torch.equal(g, want) for g in got), (got, want)
        w.copy_(w[:V // T].repeat(T, 1))
        first = torch.argmax(head_apply(cfg, model, y)[:, :V // T], dim=-1)
        got = _vocab_parallel_on_threads(cfg, model, y, T)
    assert all(torch.equal(g, first) for g in got), (got, first)


def _port_mesh(n_pipe=1, n_data=1, n_model=2, n_seq=1, n_expert=1):
    """A rank's mesh without a world: enough for the build's checks,
    which run before any collective."""
    return tmesh.Mesh(n_pipe, n_data, 0, "gloo", torch.device("cpu"),
                      n_model=n_model, n_seq=n_seq, n_expert=n_expert)


def _build(which, cfg_fields, mesh):
    if which == "decode":
        return port.make_pipeline_generate_fn(
            port.ModelConfig(**cfg_fields), D, N, mesh=mesh, device="cpu")
    return port.make_serving_step_fn(port.ModelConfig(**cfg_fields), D,
                                     mesh=mesh, device="cpu", **PROGRAM)


def _jax_build(which, cfg_fields, mesh):
    if which == "decode":
        return jpd.make_pipeline_generate_fn(dtpp.ModelConfig(**cfg_fields),
                                             mesh, N)
    return jeng.make_serving_step_fn(dtpp.ModelConfig(**cfg_fields), mesh,
                                     **PROGRAM)


def _message(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("which", ["decode", "serving"])
@pytest.mark.parametrize("axis", ["data", "seq", "expert"])
def test_other_axes_raise_jax_message(which, axis):
    """A data, seq or expert axis beside the model axis: the JAX refusal,
    word for word."""
    fields = _cfgs()["llama"]
    want = _message(lambda: _jax_build(which, fields, jmake_mesh(
        n_pipe=2, n_model=2, **{f"n_{axis}": 2})), NotImplementedError)
    got = _message(lambda: _build(which, fields, _port_mesh(
        **{f"n_{axis}": 2})), NotImplementedError)
    assert got == want


@pytest.mark.parametrize("which", ["decode", "serving"])
def test_indivisible_heads_raise_jax_message(which):
    """2 kv heads over a model axis of 4: the JAX divisibility message."""
    fields = _cfgs()["llama"]
    want = _message(lambda: _jax_build(which, fields, jmake_mesh(
        n_pipe=2, n_model=4)), ValueError)
    got = _message(lambda: _build(which, fields, _port_mesh(n_model=4)),
                   ValueError)
    assert got == want


def test_logprobs_with_vocab_parallel_head_raise_jax_message():
    """The vocab-parallel head has no whole logits to take log-probs of:
    the JAX ``_head_token``'s message."""
    want = _message(lambda: jpd._head_token(
        _jax_cfg("gpt2"), None, None, None, None, vocab_parallel=True,
        return_logprobs=True), ValueError)
    got = _message(lambda: tpd._head_token(
        port.ModelConfig(**_cfgs()["gpt2"]), None, None, None, True,
        _port_mesh(), vocab_parallel=True), ValueError)
    assert got == want


@pytest.mark.parametrize("which", ["decode", "serving"])
def test_pipe_world_raises_port_message(which):
    """A world with pipe > 1 would put the stages on ranks: refused with
    the port's own words, naming its ROADMAP.md item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as info:
        _build(which, _cfgs()["gpt2"], _port_mesh(n_pipe=2))
    assert "pipe" in str(info.value)


def test_whole_model_on_model_axis_raises():
    """A rank hands the decoder its own shard: a whole model (or another
    rank's shard) raises before any collective."""
    mesh = _port_mesh()
    cfg = port.ModelConfig(**_cfgs()["gpt2"])
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = port.make_pipeline_generate_fn(cfg, D, N, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="shard_model"):
        gen(model, torch.as_tensor(_prompt()))
    other = port.shard_model(model, cfg, n=2, index=1)
    with pytest.raises(ValueError, match="shard 0 of 2"):
        gen(other, torch.as_tensor(_prompt()))
