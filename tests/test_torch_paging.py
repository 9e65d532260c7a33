"""Parity of the PyTorch port's paged KV serving with the JAX package on the
CPU: the port's own copy of the host allocator (``serving/paging.py``)
against the JAX one under the same seeded call sequences, exhaustion and
impossible requests included (plans, page tables, refcounts, free lists,
the radix cache and every gauge equal); the paged engine against the JAX
paged engine on shared-prefix traces (tick stamps, tokens, ticks, page
gauges, COW copies and hit rates equal); the port's visit write (only the
visit's rows) against the JAX whole-table gather/scatter; and the build
validation and the summary fields. Weights are seeded numpy trees in the
JAX layout, loaded into the port through ``from_jax_params``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models.llama import (
    llama_config as jllama_config)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.serving import (
    engine as jeng, paging as jpaging)
from distributed_training_with_pipeline_parallelism_tpu.utils.telemetry import (
    serving_summary as jserving_summary)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.generate import (
    layers_with_cache)
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    rope_table)
from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (
    engine as teng, paging as tpaging)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
    serving_summary)
from test_torch_serving import _tree

D, PAGE = 2, 4
GPT2 = dict(arch="gpt2", dim=32, n_layers=4, n_heads=4, vocab_size=64,
            ffn_dim=64, max_seq_len=64)
# M = 3, C = 3; blocks of 7 ticks put block ends at every phase of the
# ring, so visits of slots that hit EOS mid-block run past their retirement
PROGRAM = dict(n_slots=3, max_len=24, prompt_max=12, out_max=10,
               prefill_chunk=3, block_ticks=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    """The JAX config and parameters and the port's config and model on
    the same seeded weights: the 4-layer GPT-2 of the serving tests, or
    ``llama-debug`` cut to 4 layers."""
    if arch == "gpt2":
        jcfg, tcfg = dtpp.ModelConfig(**GPT2), port.ModelConfig(**GPT2)
    else:
        jcfg = jllama_config("llama-debug", n_layers=4)
        tcfg = port.llama_config("llama-debug", n_layers=4)
    tree = _tree(jcfg, 0)
    return (jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg,
            port.from_jax_params(tcfg, tree, device="cpu"))


def prefix_trace(n, vocab, seed, prefix_len=8, spacing=2.0):
    """``n`` requests, each one of two seeded ``prefix_len``-token
    prefixes with a seeded tail of 0-3 tokens, budgets 1-10, arrivals
    ``spacing`` ticks apart. With pages of 4 a cached prefix of 8 is
    matched whole (two shared pages) under a tail, and to its 7th token
    (a shared page and a COW copy) without one."""
    rng = np.random.RandomState(seed)
    pre = [rng.randint(0, vocab, size=prefix_len).tolist() for _ in range(2)]
    return [port.Request(
        rid=i, prompt=pre[rng.randint(2)]
        + rng.randint(0, vocab, size=rng.randint(0, 4)).tolist(),
        max_new_tokens=int(rng.randint(1, 11)), arrival=float(i) * spacing)
        for i in range(n)]


def _jax_requests(reqs):
    return [jeng.Request(r.rid, r.prompt, r.max_new_tokens, r.arrival)
            for r in reqs]


def stamps(res):
    return [(c.rid, c.slot, c.admit_tick, c.first_token_tick, c.finish_tick,
             c.tokens, c.status, c.reason) for c in res.completions]


def frequent_token(tcfg, model, reqs, **program):
    """The token the trace's greedy streams emit most after their first:
    as ``eos_id`` it retires some requests before their budget."""
    free = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **program), model)
    outs = [t for c in free.run(reqs).completions for t in c.tokens[1:]]
    return max(set(outs), key=outs.count)


# -- the allocator ----------------------------------------------------------


def _allocator_log(mod, seed, prefix_cache):
    """Drive one allocator through a seeded sequence of admissions (bound,
    or refused and released), commits (some backwards or past the
    reservation), retirements, releases, evictions, cache drops and COW
    flushes over 4 slots and a pool of 16 pages, and log every result,
    error message and the whole allocator state after each call."""
    rng = np.random.RandomState(seed)
    alloc = mod.PagedKVAllocator(n_pages=17, page_size=PAGE,
                                 max_pages_per_slot=7, prefill_chunk=3,
                                 prefix_cache=prefix_cache)
    prefixes = [rng.randint(0, 9, size=11).tolist() for _ in range(2)]
    bound = {}
    log = []

    def state():
        pool, cache = alloc.pool, alloc.cache
        entries = [] if cache is None else sorted(
            (k, e.page, e.last_use) for k, e in cache._entries.items())
        frontier = {s: alloc.committed_rows(s) for s in range(4)}
        return (pool.refcount.tolist(), list(pool._free), entries,
                None if cache is None else (cache.n_inserted,
                                            cache.n_evicted, cache._clock),
                sorted((s, dataclasses.astuple(p))
                       for s, p in alloc._bound.items()),
                sorted(alloc._committed.items()), list(alloc._cow_holds),
                alloc.pages_used, alloc.occupancy(),
                alloc.fragmentation(frontier), alloc.prefix_hit_rate(),
                alloc.n_admitted, alloc.n_cow, alloc.matched_tokens,
                alloc.prompt_tokens)

    for _ in range(160):
        op = rng.randint(0, 9)
        try:
            if op <= 2:
                prompt = (prefixes[rng.randint(2)][:rng.randint(0, 12)]
                          + rng.randint(0, 9, size=rng.randint(1, 6)).tolist())
                budget = int(rng.randint(1, 14))
                ok = alloc.admissible(len(prompt), budget)
                plan = alloc.try_admit(prompt, budget) if ok else None
                res = ("admit", alloc.pages_needed(len(prompt), budget), ok,
                       None if plan is None else dataclasses.astuple(plan))
                free = [s for s in range(4) if s not in bound]
                if plan is not None and free and rng.rand() < 0.85:
                    alloc.bind(free[0], plan)
                    bound[free[0]] = prompt
                elif plan is not None:
                    alloc.release_plan(plan)
            elif op <= 4 and bound:
                s = sorted(bound)[rng.randint(len(bound))]
                f = alloc.committed_rows(s) + int(rng.randint(-2, 12))
                res = ("advance", s, f)
                alloc.advance(s, f)
            elif op == 5 and bound:
                s = sorted(bound)[rng.randint(len(bound))]
                res = ("retire", s, alloc.plan_for(s).pages)
                alloc.retire(s, bound.pop(s))
            elif op == 6 and bound:
                s = sorted(bound)[rng.randint(len(bound))]
                res = ("release", s)
                alloc.release(s)
                del bound[s]
            elif op == 7 and alloc.cache is not None:
                n = int(rng.randint(0, 4))
                res = ("evict", n, alloc.cache.evict(n),
                       alloc.cache.match(prefixes[rng.randint(2)]))
                if rng.rand() < 0.1:
                    alloc.cow_flush()
                    alloc.cache.drop_all()
            else:
                res = ("flush",)
                alloc.cow_flush()
        except ValueError as e:
            res = ("error", str(e))
        log.append((res, state()))
    for s in sorted(bound):  # drain
        alloc.advance(s, max(alloc.committed_rows(s),
                             alloc.plan_for(s).plen))
        alloc.retire(s, bound.pop(s))
    alloc.cow_flush()
    alloc.check_invariants()
    log.append(("drained", state()))
    return log


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_jax(seed, prefix_cache):
    """The same seeded call sequence through the JAX ``PagedKVAllocator``
    and the port's copy: every plan (pages, matched length, shared pages,
    COW pair), refusal, error message, refcount, free list, cache entry
    and gauge equal after every call; both drain clean."""
    want = _allocator_log(jpaging, seed, prefix_cache)
    got = _allocator_log(tpaging, seed, prefix_cache)
    assert got == want
    kinds = {r[0][0] for r in got[:-1]}
    assert {"admit", "advance", "retire", "error"} <= kinds
    assert any(r[0][0] == "admit" and r[0][3] is None for r in got[:-1])


def test_pool_and_cache_units_match_jax():
    """``pages_for``, the pool's refusals and its errors, and the radix
    cache's match, insert and LRU eviction, call for call."""
    for n, ps in [(0, 4), (1, 4), (4, 4), (5, 4), (17, 3)]:
        assert tpaging.pages_for(n, ps) == jpaging.pages_for(n, ps)
    for args in [(1, 4), (6, 0)]:
        with pytest.raises(ValueError) as want:
            jpaging.PagePool(*args)
        with pytest.raises(ValueError) as got:
            tpaging.PagePool(*args)
        assert str(got.value) == str(want.value)

    def drive(mod):
        pool = mod.PagePool(n_pages=10, page_size=2)
        cache = mod.RadixPrefixCache(pool)
        pages = pool.alloc(3)
        out = [pages, cache.insert([5, 6, 7, 8, 9], 5, pages),
               cache.match([5, 6, 7, 8, 9]), cache.match([5, 6, 99]),
               pool.alloc(12)]
        for pg in pages:
            out.append(pool.decref(pg))
        pool.incref(pages[0])
        out += [cache.evict(10), cache.match([5, 6, 7, 8]), pool.n_used]
        for bad in (lambda: pool.incref(0), lambda: pool.decref(0),
                    lambda: pool.decref(pages[2]), lambda: pool.alloc(-1)):
            try:
                bad()
            except ValueError as e:
                out.append(str(e))
        return out + [pool.refcount.tolist(), list(pool._free)]

    assert drive(tpaging) == drive(jpaging)


# -- the paged engine -------------------------------------------------------


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_paged_engine_matches_jax(arch):
    """A shared-prefix trace with an ``eos_id`` through the JAX paged
    engine and the port's: completions in the same order with the same
    slot, stamps and tokens, the same ticks, page-use and fragmentation
    series, COW copies, skipped prefill and hit rate; the tokens also
    equal the port's contiguous engine's; one blocking read a block; the
    drained allocator holds only cached pages."""
    jcfg, params, tcfg, model = _models(arch)
    reqs = prefix_trace(9, tcfg.vocab_size, seed=1)
    eos = frequent_token(tcfg, model, reqs, **PROGRAM)
    kw = dict(PROGRAM, eos_id=eos, paged=True, page_size=PAGE)
    want = jeng.ServingEngine(jeng.make_serving_step_fn(
        jcfg, make_mesh(n_pipe=D), **kw), params).run(_jax_requests(reqs))
    engine = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **kw), model)
    got = engine.run(reqs)
    assert stamps(got) == stamps(want)
    for f in ("ticks", "busy_ticks", "occupancy", "queue_depth",
              "pages_capacity", "pages_used", "page_fragmentation",
              "prefix_hit_rate", "prefill_skipped_tokens", "n_cow",
              "n_backpressure"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_cow > 0 and got.prefix_hit_rate > 0
    budgets = {r.rid: r.max_new_tokens for r in reqs}
    assert any(len(c.tokens) < budgets[c.rid] for c in got.completions)
    assert got.host_syncs == got.n_blocks > 0
    engine.paging.check_invariants()
    contiguous = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **dict(PROGRAM, eos_id=eos)), model).run(reqs)
    assert {c.rid: c.tokens for c in got.completions} == \
        {c.rid: c.tokens for c in contiguous.completions}


def test_paged_backpressure_matches_jax():
    """A pool of 7 usable pages for requests of 5: admissions wait
    (backpressure) and none fails, as in the JAX engine, stamp for stamp;
    a request larger than the pool fails at once with the JAX reason."""
    jcfg, params, tcfg, model = _models("gpt2")
    rng = np.random.RandomState(1)
    reqs = [port.Request(i, rng.randint(1, 64, size=8).tolist(), 10)
            for i in range(5)]
    kw = dict(PROGRAM, prompt_max=8, eos_id=None, paged=True,
              page_size=PAGE, n_pages=8)
    jprog = jeng.make_serving_step_fn(jcfg, make_mesh(n_pipe=D), **kw)
    tprog = port.make_serving_step_fn(tcfg, D, device="cpu", **kw)
    want = jeng.ServingEngine(jprog, params).run(_jax_requests(reqs))
    engine = port.ServingEngine(tprog, model)
    got = engine.run(reqs)
    assert stamps(got) == stamps(want)
    assert got.n_backpressure == want.n_backpressure > 0
    assert got.n_failed == 0
    engine.paging.check_invariants()
    tiny = dict(kw, n_pages=4)
    big = [port.Request(0, [1] * 8, 10)]
    jres = jeng.ServingEngine(jeng.make_serving_step_fn(
        jcfg, make_mesh(n_pipe=D), **tiny), params).run(_jax_requests(big))
    tres = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **tiny), model).run(big)
    assert stamps(tres) == stamps(jres)
    assert tres.n_failed == 1 and "pages" in tres.completions[0].reason


def test_prefix_cache_off_and_out_of_vocab_admission():
    """``prefix_cache=False`` reuses nothing (hit rate 0, no COW) with
    the same tokens; a prompt with a token outside the vocabulary fails
    its admission and returns its pages, so the pool drains clean."""
    _, _, tcfg, model = _models("gpt2")
    reqs = prefix_trace(6, tcfg.vocab_size, seed=2)
    prog = port.make_serving_step_fn(tcfg, D, device="cpu", paged=True,
                                     page_size=PAGE, **PROGRAM)
    on = port.ServingEngine(prog, model).run(reqs)
    engine = port.ServingEngine(prog, model, prefix_cache=False)
    off = engine.run(reqs + [port.Request(99, [1, 64], 2, 0.0)])
    assert on.prefix_hit_rate > 0
    assert off.prefix_hit_rate == 0.0 and off.n_cow == 0
    assert [c.reason for c in off.completions if c.status == "failed"] == \
        ["admission failed: prompt tokens must be ids in [0, 64)"]
    assert {c.rid: c.tokens for c in off.completions if c.rid != 99} == \
        {c.rid: c.tokens for c in on.completions}
    engine.paging.check_invariants()


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_visit_write_equals_whole_table_scatter(arch):
    """One paged visit over a page row holding a shared page, a COW'd
    page, fresh pages and null entries: the port's write (only the
    visit's C rows) leaves the pool bit-identical to the JAX scheme run in
    torch (gather the row's pages, write at the offset, scatter the whole
    view back, duplicate null entries included) and gives its hidden
    state; and both match the JAX ``_paged_cache_apply`` within 1e-5."""
    jcfg, params, tcfg, model = _models(arch)
    lps, C, pmax = 2, 3, 6
    layers = model.layers[:lps]
    rng = np.random.default_rng(3)
    shape = (lps, 12, PAGE, tcfg.kv_heads, tcfg.head_dim)
    kp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pt = torch.tensor([5, 2, 9, 7, 0, 0])
    offset = 6  # rows 6..8: pages 2 (second half) and 9
    h = torch.from_numpy(rng.standard_normal(
        (1, C, tcfg.dim)).astype(np.float32))
    pos = offset + torch.arange(C)
    rope = rope_table(tcfg, pmax * PAGE, "cpu")
    with torch.no_grad():
        kg, vg = kp.clone(), vp.clone()
        got = teng._apply_layers(tcfg, layers, h, kg, vg, pos, rope,
                                 torch.zeros(1, dtype=torch.long), pt,
                                 torch.arange(pmax * PAGE))
        kw, vw = kp[:, pt].reshape(lps, 1, pmax * PAGE, *shape[3:]), \
            vp[:, pt].reshape(lps, 1, pmax * PAGE, *shape[3:])
        want = layers_with_cache(tcfg, layers, h, kw, vw, offset, rope)
        ks, vs = kp.clone(), vp.clone()
        ks[:, pt] = kw.reshape(lps, pmax, *shape[2:])
        vs[:, pt] = vw.reshape(lps, pmax, *shape[2:])
    assert torch.equal(kg, ks) and torch.equal(vg, vs)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    untouched = [p for p in range(12) if p not in (2, 9)]
    assert torch.equal(kg[:, untouched], kp[:, untouched])
    jlayers = jax.tree.map(lambda x: x[:lps], params["layers"])
    jh, jk, jv = jeng._paged_cache_apply(
        jcfg, jlayers, jax.numpy.asarray(h.numpy()),
        jax.numpy.asarray(kp.numpy()), jax.numpy.asarray(vp.numpy()),
        jax.numpy.asarray(pt.numpy(), jax.numpy.int32), offset, C)
    for a, b in ((got, jh), (kg, jk), (vg, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [dict(page_size=0), dict(n_pages=1)])
def test_paged_build_errors_match_jax(kw):
    """The paged ``ValueError``s of the JAX ``make_serving_step_fn``, with
    the same messages; the default pool is ``1 + M * P_max`` pages."""
    args = dict(PROGRAM, paged=True, **kw)
    with pytest.raises(ValueError) as want:
        jeng.make_serving_step_fn(dtpp.ModelConfig(**GPT2),
                                  make_mesh(n_pipe=D), **args)
    with pytest.raises(ValueError) as got:
        port.make_serving_step_fn(port.ModelConfig(**GPT2), D,
                                  device="cpu", **args)
    assert str(got.value) == str(want.value)
    prog = port.make_serving_step_fn(port.ModelConfig(**GPT2), D,
                                     device="cpu", paged=True, page_size=5,
                                     **PROGRAM)
    assert prog.max_pages_per_slot == 6 and prog.n_pages == 1 + 3 * 6


def test_paged_summary_matches_jax():
    """``serving_summary`` of a paged result carries the JAX page gauges,
    equal to the JAX summary's; a contiguous one carries none."""
    def result(mod, **paged):
        return mod.ServeResult(
            completions=[], occupancy=[(3, 2), (6, 1)], ticks=6,
            wall_s=0.5, n_slots=3, policy="continuous", busy_ticks=6,
            **paged)
    paged = dict(paged=True, pages_capacity=18,
                 pages_used=[(3, 5), (6, 7)],
                 page_fragmentation=[(3, 0.25), (6, 0.125)],
                 prefix_hit_rate=0.4, prefill_skipped_tokens=12, n_cow=2,
                 n_backpressure=1)
    got = serving_summary(result(teng, **paged))
    assert got == jserving_summary(result(jeng, **paged))
    assert got["pages_used_max"] == 7 and got["n_cow"] == 2
    assert "paged" not in serving_summary(result(teng))
