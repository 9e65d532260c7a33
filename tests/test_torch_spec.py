"""Parity of the PyTorch port's speculative (draft-verify) serving with the
JAX package on the CPU: ``spec_accept_len`` on random proposals; the
speculative engine, with a random draft and with the target as its own
draft, alone and together with paged KV, against the JAX speculative
engine (tick stamps, tokens, ticks, verify visits, accepted tokens, the
acceptance series and the page gauges equal; one blocking read a block);
the build and engine validation with the JAX messages; and the summary
fields. Weights are seeded numpy trees in the JAX layout, loaded into the
port through ``from_jax_params``."""

import numpy as np
import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipelined_decode import (
    spec_accept_len as jspec_accept_len)
from distributed_training_with_pipeline_parallelism_tpu.serving import (
    engine as jeng)
from distributed_training_with_pipeline_parallelism_tpu.utils.telemetry import (
    serving_summary as jserving_summary)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.pipelined_decode import (
    spec_accept_len)
from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (
    engine as teng)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
    serving_summary)
from test_torch_paging import (D, GPT2, PAGE, PROGRAM, _jax_requests,
                               _models, frequent_token, prefix_trace, stamps)
from test_torch_serving import _tree

GAMMA = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draft(tcfg):
    """A random 2-layer draft of the target's family and vocabulary: the
    JAX config and parameters and the port's model (seed 99)."""
    kw = dict(dim=32, n_layers=2, n_heads=4, vocab_size=tcfg.vocab_size,
              ffn_dim=48, max_seq_len=64, arch=tcfg.arch)
    if tcfg.arch == "llama":
        kw["n_kv_heads"] = 2
    jcfg, dcfg = dtpp.ModelConfig(**kw), port.ModelConfig(**kw)
    tree = _tree(jcfg, 99)
    return (jcfg, jax.tree.map(jax.numpy.asarray, tree), dcfg,
            port.from_jax_params(dcfg, tree, device="cpu"))


def _trace(tcfg, n, seed):
    rng = np.random.RandomState(seed)
    return [port.Request(
        rid=i, prompt=rng.randint(0, tcfg.vocab_size,
                                  size=int(rng.randint(1, 12))).tolist(),
        max_new_tokens=int(rng.randint(1, 11)), arrival=float(i) * 2.0)
        for i in range(n)]


def test_spec_accept_len_matches_jax():
    """On random proposals and argmaxes (matches planted at random
    depths), numpy and torch inputs: the JAX function's accepted length,
    exactly, in ``[1, gamma + 1]``."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        g = int(rng.integers(1, 6))
        targets = rng.integers(0, 4, size=g + 1 + int(rng.integers(0, 3)))
        drafts = targets[:g].copy()
        k = int(rng.integers(0, g + 1))
        drafts[k:] = rng.integers(0, 4, size=g - k)
        want = int(jspec_accept_len(drafts, targets))
        got = spec_accept_len(drafts, targets)
        assert isinstance(got, np.integer) and int(got) == want
        got_t = spec_accept_len(torch.from_numpy(drafts),
                                torch.from_numpy(targets))
        assert got_t.dim() == 0 and int(got_t) == want
        assert 1 <= want <= g + 1


# each draft and each arch alone and paged
CASES = {
    "gpt2-random-draft": ("gpt2", "random", False),
    "llama-self-draft": ("llama", "self", False),
    "gpt2-self-draft-paged": ("gpt2", "self", True),
    "llama-random-draft-paged": ("llama", "random", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_engine_matches_jax(case):
    """One trace with an ``eos_id`` through the JAX speculative engine and
    the port's (gamma 2, C = 3, blocks of 7 ticks): completions in the
    same order with the same slot, stamps and tokens; the same ticks,
    verify visits, accepted tokens and acceptance series, and when paged
    (a shared-prefix trace: the draft starts cold past the cached prefix
    and catches up) the same page gauges, COW copies and hit rate. The
    tokens equal the port's plain engine's; a self-draft accepts and
    takes fewer ticks; one blocking read a block."""
    arch, draft, paged = CASES[case]
    jcfg, params, tcfg, model = _models(arch)
    if draft == "self":
        djcfg, dparams, dtcfg, dmodel = jcfg, params, tcfg, model
    else:
        djcfg, dparams, dtcfg, dmodel = _draft(tcfg)
    reqs = (prefix_trace(8, tcfg.vocab_size, seed=4) if paged
            else _trace(tcfg, 7, seed=3))
    eos = frequent_token(tcfg, model, reqs, **PROGRAM)
    mode = dict(PROGRAM, eos_id=eos, speculative=True, gamma=GAMMA)
    if paged:
        mode.update(paged=True, page_size=PAGE)
    want = jeng.ServingEngine(
        jeng.make_serving_step_fn(jcfg, make_mesh(n_pipe=D),
                                  draft_cfg=djcfg, **mode),
        params, draft_params=dparams).run(_jax_requests(reqs))
    engine = port.ServingEngine(
        port.make_serving_step_fn(tcfg, D, device="cpu", draft_cfg=dtcfg,
                                  **mode), model, draft_params=dmodel)
    got = engine.run(reqs)
    assert stamps(got) == stamps(want)
    fields = ["ticks", "busy_ticks", "occupancy", "queue_depth", "gamma",
              "spec_verify_visits", "spec_accepted_tokens",
              "acceptance_series"]
    if paged:
        fields += ["pages_used", "page_fragmentation", "prefix_hit_rate",
                   "prefill_skipped_tokens", "n_cow"]
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.spec_verify_visits > 0
    assert got.host_syncs == got.n_blocks > 0
    plain = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **dict(PROGRAM, eos_id=eos)), model).run(reqs)
    assert {c.rid: c.tokens for c in got.completions} == \
        {c.rid: c.tokens for c in plain.completions}
    if draft == "self":
        assert got.ticks < plain.ticks
        assert got.acceptance_rate > 0.5
        assert 1.0 < got.accepted_len_mean <= GAMMA + 1
    if paged:
        assert got.prefix_hit_rate > 0
        engine.paging.check_invariants()


SPEC_ERRORS = [
    dict(),  # no draft_cfg
    dict(draft=dict(), gamma=0),
    dict(draft=dict(), gamma=3),
    dict(draft=dict(arch="ref_decoder")),
    dict(draft=dict(vocab_size=32)),
    dict(draft=dict(max_seq_len=16)),
]


@pytest.mark.parametrize("kw", SPEC_ERRORS)
def test_spec_build_errors_match_jax(kw):
    """Each speculative ``ValueError`` of the JAX ``make_serving_step_fn``
    (a draft config is needed; gamma >= 1 and gamma + 1 <= C; the draft
    generable, of the target's vocabulary, and for GPT-2 with a position
    table covering the slot), raised by the port with the same message."""
    kw = dict(kw)
    draft = kw.pop("draft", None)
    args = dict(PROGRAM, speculative=True, gamma=kw.pop("gamma", GAMMA))
    jdraft = tdraft = None
    if draft is not None:
        size = dict(GPT2, n_layers=2, **draft)
        jdraft, tdraft = dtpp.ModelConfig(**size), port.ModelConfig(**size)
    with pytest.raises(ValueError) as want:
        jeng.make_serving_step_fn(dtpp.ModelConfig(**GPT2),
                                  make_mesh(n_pipe=D), draft_cfg=jdraft,
                                  **args)
    with pytest.raises(ValueError) as got:
        port.make_serving_step_fn(port.ModelConfig(**GPT2), D,
                                  device="cpu", draft_cfg=tdraft, **args)
    assert str(got.value) == str(want.value)


def test_engine_needs_a_draft():
    """A speculative program without ``draft_params`` raises, and its
    slot-table layout leaves room for the output buffer."""
    tcfg = port.ModelConfig(**GPT2)
    prog = port.make_serving_step_fn(tcfg, D, device="cpu",
                                     speculative=True, gamma=GAMMA,
                                     draft_cfg=tcfg, **PROGRAM)
    model = port.from_jax_params(tcfg, _tree(dtpp.ModelConfig(**GPT2), 0),
                                 device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        port.ServingEngine(prog, model)
    assert prog.init_state()["slots"].shape == (
        3, teng._NCOL + PROGRAM["out_max"])


def test_spec_summary_matches_jax():
    """``serving_summary`` of a speculative result (and of one that
    finished before its first verify) carries the JAX acceptance gauges,
    equal to the JAX summary's; a plain one carries none."""
    def result(mod, **spec):
        return mod.ServeResult(completions=[], occupancy=[], ticks=4,
                               wall_s=0.1, n_slots=2, policy="continuous",
                               **spec)
    for spec in (dict(speculative=True, gamma=2, spec_verify_visits=10,
                      spec_accepted_tokens=15,
                      acceptance_series=[(3, 0.75), (4, None)]),
                 dict(speculative=True, gamma=2)):
        got = serving_summary(result(teng, **spec))
        assert got == jserving_summary(result(jeng, **spec))
    assert got["acceptance_rate"] is None
    s = serving_summary(result(teng, speculative=True, gamma=2,
                               spec_verify_visits=10,
                               spec_accepted_tokens=15))
    assert s["acceptance_rate"] == 0.75 and s["accepted_len_mean"] == 2.5
    assert "speculative" not in serving_summary(result(teng))
