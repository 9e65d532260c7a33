"""The port's static table verifier, phase compression, schedule artifacts
and search against the JAX package on the CPU (host numpy on both sides).

- ``check_table``'s ``TableReport.summary()`` equals JAX's over the grid
  of ``tests/test_analysis.py::test_shipped_schedules_verify_clean``, and
  over the JAX mutation cases (``tests/test_analysis.py``, one corrupted
  cell each) and a seeded corpus of random one-cell mutations, hazard
  strings included; ``recheck_after_swap`` equals JAX's on the corpus;
- ``check_forward_table`` on the eval executor's tables (bit-identical to
  JAX's), ``check_serving_ring``, ``page_table_hazards`` and
  ``static_analysis_section`` equal JAX's;
- ``compress_schedule`` gives JAX's phases and replays bit for bit;
- the search writes JAX's artifact bytes for one spec and seed; an
  artifact from either side loads in the other with the same digest; a
  tampered cell, a stale fingerprint and broken schemas fail in both
  with the same message; a registered artifact is pinned;
- the build-time hooks raise JAX's messages, and the cost and memory
  models take a precomputed report as JAX's do.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu import (
    analysis as janalysis)
from distributed_training_with_pipeline_parallelism_tpu.analysis import (
    cost_model as jcm, memory_model as jmm, schedule_search as jss,
    table_check as jtc)
from distributed_training_with_pipeline_parallelism_tpu.analysis.cli import (
    default_grid)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsch)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    _fwd_tick_table as jfwd_table)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import (
    analysis as tanalysis, search_schedule as tsearch_main)
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    cost_model as tcm, memory_model as tmm, schedule_search as tss,
    table_check as ttc)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsch)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.pipeline import (
    _fwd_tick_table as tfwd_table)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
    virtual_stages_for)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.schedules import (
    COL_BWD_ASLOT, COL_BWD_GSLOT, COL_BWD_M, COL_BWD_V, COL_FWD_LOCAL_SLOT,
    COL_FWD_M, COL_FWD_SLOT, COL_FWD_V, COL_STORE_F_SLOT, COL_W_ASLOT,
    COL_W_M)

GRID = default_grid()


def _both(name, D, V, M):
    return (jsch.compile_schedule(name, D, V, M),
            tsch.compile_schedule(name, D, V, M))


def _mutated(cs, table):
    return dataclasses.replace(cs, table=table)


def _same_reports(jcs, tcs, table=None):
    """Both verifiers on (a copy of) one table: equal summaries."""
    if table is not None:
        jcs, tcs = _mutated(jcs, table.copy()), _mutated(tcs, table.copy())
    j, t = jtc.check_table(jcs), ttc.check_table(tcs)
    assert t.summary() == j.summary()
    return t


@pytest.mark.parametrize("name,D,V,M", GRID, ids=lambda v: str(v))
def test_reports_equal_jax(name, D, V, M):
    """A clean report, equal to JAX's: slot peaks, hop counts, unit
    counts, compression and the ring's bank discipline."""
    jcs, tcs = _both(name, D, V, M)
    assert np.array_equal(jcs.table, tcs.table)
    rep = _same_reports(jcs, tcs)
    assert rep.ok and rep.predicted_ppermutes > 0
    assert ttc.hops_per_tick(tcs.table).sum() == rep.predicted_ppermutes


@pytest.mark.parametrize("name,D,V,M", GRID, ids=lambda v: str(v))
def test_phase_round_trip_equal_jax(name, D, V, M):
    """``compress_schedule`` gives JAX's phases; replay is bitwise."""
    jcs, tcs = _both(name, D, V, M)
    jp, tp = jsch.compress_schedule(jcs.table), tsch.compress_schedule(
        tcs.table)
    assert [(p.start, p.period, p.reps) for p in tp] == \
        [(p.start, p.period, p.reps) for p in jp]
    for a, b in zip(tp, jp):
        assert np.array_equal(a.base, b.base)
        assert np.array_equal(a.stride, b.stride)
        assert a.pattern_key() == b.pattern_key()
    assert np.array_equal(tsch.replay_phases(tp), tcs.table)
    assert tsch.phase_stats(tp) == jsch.phase_stats(jp)
    assert tsch.phase_spans(tp) == jsch.phase_spans(jp)
    assert np.array_equal(tsch.phase_unit_activity(tp),
                          jsch.phase_unit_activity(jp))


def _find(table, pred, devices=None):
    for t in range(table.shape[0]):
        for d in (devices if devices is not None else range(table.shape[1])):
            if pred(table[t, d]):
                return t, d
    raise AssertionError("no matching cell")


def _m_fwd_slot(tb, cs):
    t, d = _find(tb, lambda r: r[COL_FWD_M] >= 0 and r[COL_FWD_SLOT] >= 0,
                 range(1, cs.n_devices))
    tb[t, d, COL_FWD_SLOT] = (tb[t, d, COL_FWD_SLOT] + 1) % cs.n_act_slots
    return "read-wrong-value", d, t, "COL_FWD_SLOT"


def _m_drop_store(tb, cs):
    t, d = _find(tb, lambda r: r[COL_STORE_F_SLOT] >= 0)
    tb[t, d, COL_STORE_F_SLOT] = -1
    return "send-unpaired", d, t, "COL_STORE_F_SLOT"


def _m_spurious_store(tb, cs):
    tb[0, 0, COL_STORE_F_SLOT] = 0
    return "recv-unpaired", 0, 0, "COL_STORE_F_SLOT"


def _m_spurious_local(tb, cs):
    t, d = _find(tb, lambda r: r[COL_FWD_M] >= 0
                 and int(r[COL_FWD_V]) * cs.n_devices <= cs.n_stages - 2)
    tb[t, d, COL_FWD_LOCAL_SLOT] = 0
    return "route-mismatch", d, t, "COL_FWD_LOCAL_SLOT"


def _m_cleared_local(tb, cs):
    t, d = _find(tb, lambda r: r[COL_FWD_LOCAL_SLOT] >= 0)
    tb[t, d, COL_FWD_LOCAL_SLOT] = -1
    return "route-mismatch", d, t, "COL_FWD_LOCAL_SLOT"


def _m_bwd_aslot(tb, cs):
    t, d = _find(tb, lambda r: r[COL_BWD_M] >= 0)
    tb[t, d, COL_BWD_ASLOT] = (tb[t, d, COL_BWD_ASLOT] + 1) % cs.n_act_slots
    return "read-wrong-value", d, t, "COL_BWD_ASLOT"


def _m_gslot_oob(tb, cs):
    t, d = _find(tb, lambda r: r[COL_BWD_M] >= 0 and r[COL_BWD_GSLOT] >= 0
                 and int(r[COL_BWD_V]) * cs.n_devices < cs.n_stages - 1)
    tb[t, d, COL_BWD_GSLOT] = cs.n_grad_slots
    return "slot-out-of-bounds", d, t, "COL_BWD_GSLOT"


def _m_duplicate_mb(tb, cs):
    hits = [t for t in range(tb.shape[0]) if tb[t, 0, COL_FWD_M] >= 0]
    tb[hits[1], 0, COL_FWD_M] = tb[hits[0], 0, COL_FWD_M]
    return "duplicate-unit", 0, hits[1], "COL_FWD_M"


def _m_w_alias(tb, cs):
    t, d = _find(tb, lambda r: r[COL_W_M] >= 0, [1])
    tb[t, d, COL_W_ASLOT] = (tb[t, d, COL_W_ASLOT] + 1) % max(
        cs.n_act_slots, 2)
    return "w-slot-alias", d, t, "COL_W_ASLOT"


def _m_war_redirect(tb, cs):
    stores = [t for t in range(tb.shape[0]) if tb[t, 1, COL_STORE_F_SLOT] >= 0]
    tb[stores[1], 1, COL_STORE_F_SLOT] = tb[stores[0], 1, COL_STORE_F_SLOT]
    return "overwrite-live", 1, stores[1], "COL_STORE_F_SLOT"


def _m_cleared_bwd(tb, cs):
    t, d = _find(tb, lambda r: r[COL_BWD_M] >= 0, range(1, cs.n_devices))
    tb[t, d, [COL_BWD_V, COL_BWD_M, COL_BWD_ASLOT, COL_BWD_GSLOT]] = -1
    return "recv-unpaired", (d - 1) % cs.n_devices, t + 1, "COL_STORE_B_SLOT"


def _m_double_store(tb, cs):
    t, d = _find(tb, lambda r: r[COL_STORE_F_SLOT] >= 0
                 and r[COL_FWD_LOCAL_SLOT] >= 0)
    tb[t, d, COL_FWD_LOCAL_SLOT] = tb[t, d, COL_STORE_F_SLOT]
    return "double-store", d, t, "COL_FWD_LOCAL_SLOT"


# the JAX package's mutation cases (tests/test_analysis.py), one cell each
MUTATIONS = {
    "swap_fwd_input_slot": (("1F1B", 4, 1, 8), _m_fwd_slot),
    "drop_store": (("GPipe", 4, 1, 4), _m_drop_store),
    "spurious_store": (("GPipe", 2, 1, 4), _m_spurious_store),
    "spurious_local_route_on_wrap": (("1F1B", 4, 1, 4), _m_spurious_local),
    "cleared_local_route_on_vshape": (("ZBV", 2, 2, 4), _m_cleared_local),
    "swap_bwd_saved_input_slot": (("1F1B", 4, 1, 8), _m_bwd_aslot),
    "grad_slot_out_of_bounds": (("1F1B", 4, 1, 8), _m_gslot_oob),
    "duplicate_microbatch": (("GPipe", 2, 1, 4), _m_duplicate_mb),
    "w_slot_alias_broken": (("ZBH1", 2, 1, 4), _m_w_alias),
    "war_store_redirect": (("GPipe", 2, 1, 4), _m_war_redirect),
    "cleared_backward_unit": (("1F1B", 4, 1, 4), _m_cleared_bwd),
    "double_store_same_tick": (("ZBV", 2, 2, 4), _m_double_store),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_reports_equal_jax(case):
    """The corrupted cell is located, and the whole report (hazard
    strings included) is JAX's."""
    shape, mutate = MUTATIONS[case]
    jcs, tcs = _both(*shape)
    table = np.array(tcs.table, copy=True)
    kind, d, t, col = mutate(table, tcs)
    rep = _same_reports(jcs, tcs, table)
    assert any((h.kind, h.device, h.tick, h.column) == (kind, d, t, col)
               for h in rep.hazards), [str(h) for h in rep.hazards]


@pytest.mark.parametrize("name,D,V,M", [("1F1B", 4, 1, 8), ("ZBH1", 4, 1, 4),
                                        ("Interleaved1F1B", 2, 2, 4),
                                        ("ZBV", 2, 2, 4)])
def test_random_mutations_and_recheck_equal_jax(name, D, V, M):
    """Twelve seeded random one-cell mutations: the full reports and the
    incremental ``recheck_after_swap`` from a clean baseline equal
    JAX's."""
    jcs, tcs = _both(name, D, V, M)
    jbase = jtc.check_table_baseline(jcs)
    tbase = ttc.check_table_baseline(tcs)
    assert tbase.report.summary() == jbase.report.summary()
    rng = np.random.default_rng(hash(name) % 2 ** 32 + D * 100 + M)
    for _ in range(12):
        table = np.array(tcs.table, copy=True)
        t, d, c = (int(rng.integers(n)) for n in table.shape)
        table[t, d, c] = (-1 if table[t, d, c] >= 0
                          else int(rng.integers(0, 3)))
        _same_reports(jcs, tcs, table)
        jr = jtc.recheck_after_swap(_mutated(jcs, table.copy()), jbase)
        tr = ttc.recheck_after_swap(_mutated(tcs, table.copy()), tbase)
        assert tr.summary() == jr.summary()
    hit = ttc.check_table_cached(tcs)
    assert ttc.check_table_cached(tcs) is hit


def test_forward_serving_and_page_checks_equal_jax():
    """The eval executor's forward tables are JAX's bit for bit and their
    reports (and a dropped store's) equal; the serving ring's reports
    over D, M and the speculative and paging options; page-table hazards
    over seeded rows; and ``static_analysis_section``."""
    reports = []
    for D, V, M in itertools.product((1, 2, 4), (1, 2), (1, 4, 8)):
        jt, jn = jfwd_table(D, V, M)
        tt, tn = tfwd_table(D, V, M)
        assert np.array_equal(jt, tt) and jn == tn
        j = jtc.check_forward_table(jt, D, V, M, jn)
        t = ttc.check_forward_table(tt, D, V, M, tn)
        assert t.summary() == j.summary() and t.ok
        reports.append(t)
    tt, tn = tfwd_table(2, 1, 4)
    t0, d0 = _find(tt, lambda r: r[0] >= 0)
    bad = np.array(tt, copy=True)
    bad[t0, d0, 0] = -1
    assert ttc.check_forward_table(bad, 2, 1, 4, tn).summary() == \
        jtc.check_forward_table(bad, 2, 1, 4, tn).summary()
    rng = np.random.default_rng(0)
    n_pages, ps = 12, 4
    refcount = rng.integers(0, 3, n_pages)
    paging = dict(page_tbl=[[1, 2, 0], [3, 3, 0], [13, 4, 5]],
                  refcount=refcount, n_pages=n_pages, page_size=ps,
                  spans=[(0, 9), (2, 7), (0, 30)], cow_dst=[-1, 3, -1])
    for D, M in itertools.product((1, 2, 4), (1, 3, 4, 6)):
        for spec in (None, dict(gamma=2, prefill_chunk=3),
                     dict(gamma=4, prefill_chunk=3,
                          slots=[{"n_accepted": 6, "pos": 3, "committed": 5,
                                  "mapped_rows": 4}])):
            for pg in (None, paging):
                j = jtc.check_serving_ring(D, M, paging=pg, speculative=spec)
                t = ttc.check_serving_ring(D, M, paging=pg, speculative=spec)
                assert t.summary() == j.summary()
                reports.append(t)
    for _ in range(20):
        pages = rng.integers(-1, n_pages + 1, int(rng.integers(1, 5)))
        lo, hi = sorted(int(x) for x in rng.integers(0, 24, 2))
        kw = dict(refcount=refcount, n_pages=n_pages, page_size=ps,
                  write_lo=lo, write_hi=hi, cow_dst=int(rng.integers(-1, 4)),
                  slot=2)
        assert [str(h) for h in ttc.page_table_hazards(pages, **kw)] == \
            [str(h) for h in jtc.page_table_hazards(pages, **kw)]
    jreports = [jtc.check_forward_table(*jfwd_table(2, 1, 4)[:1], 2, 1, 4,
                                        jfwd_table(2, 1, 4)[1]),
                jtc.check_table(jsch.compile_schedule("ZBV", 2, 2, 4))]
    treports = [ttc.check_forward_table(*tfwd_table(2, 1, 4)[:1], 2, 1, 4,
                                        tfwd_table(2, 1, 4)[1]),
                ttc.check_table(tsch.compile_schedule("ZBV", 2, 2, 4))]
    assert ttc.static_analysis_section(treports, tanalysis.VERIFIER_VERSION) \
        == jtc.static_analysis_section(jreports, janalysis.VERIFIER_VERSION)
    assert len(reports) > 60


SPECS = [dict(n_devices=4, n_microbatches=4, iterations=60, seed=3),
         dict(n_devices=2, n_microbatches=4, split_backward=False,
              iterations=40, hop_s=0.1, objective="comm_overlap")]


@pytest.fixture(scope="module")
def searched():
    """Each spec searched by both packages: (JAX result, port result)."""
    return [(jss.search_schedule(jss.SearchSpec(**kw)),
             tss.search_schedule(tss.SearchSpec(**kw))) for kw in SPECS]


def test_search_artifact_bytes_equal_jax(searched):
    """One spec and seed, one artifact: the bytes, the predicted cost,
    the baseline and the certified report are JAX's."""
    for j, t in searched:
        assert tsch.schedule_artifact_bytes(t.artifact) == \
            jsch.schedule_artifact_bytes(j.artifact)
        assert t.report.ok and t.beats_1f1b == j.beats_1f1b
    spec = tss.SearchSpec(**SPECS[0])
    assert [(k, o) for k, o in tss.seed_orders(spec)] == \
        [(k, [[tsch.Action(a.stage, a.op, a.microbatch) for a in dev]
              for dev in o])
         for k, o in jss.seed_orders(jss.SearchSpec(**SPECS[0]))]
    assert tss.one_f_one_b_baseline(spec) == jss.one_f_one_b_baseline(
        jss.SearchSpec(**SPECS[0]))
    for bad in (dict(n_devices=0), dict(placement="vshape"),
                dict(objective="x"), dict(act_bytes_budget=10.0)):
        kw = dict(SPECS[0], **bad)
        with pytest.raises(jsch.ScheduleError) as je:
            jss.search_schedule(jss.SearchSpec(**kw))
        with pytest.raises(tsch.ScheduleError) as te:
            tss.search_schedule(tss.SearchSpec(**kw))
        assert str(te.value) == str(je.value)


def _load_error(mod, art):
    with pytest.raises(mod.ScheduleError) as e:
        mod.load_schedule_artifact(art)
    return str(e.value)


def test_artifacts_cross_load_and_fail_alike(searched, tmp_path):
    """An artifact from either side loads in the other with the same
    digest; a tampered cell, an edited field, a broken table and broken
    orders fail in both with the same message."""
    j, t = searched[0]
    for src, mod in ((j.artifact, tsch), (t.artifact, jsch)):
        path = tmp_path / "a.json"
        path.write_bytes(jsch.schedule_artifact_bytes(src))
        cs = mod.load_schedule_artifact(str(path))
        assert mod.table_digest(cs.table) == src["table_digest"]
    art = json.loads(tsch.schedule_artifact_bytes(t.artifact))
    cell = next((tt, d, c) for tt, row in enumerate(art["table"])
                for d, cells in enumerate(row) for c, v in enumerate(cells)
                if v >= 0 and c == COL_FWD_SLOT and tt > 2)
    tampered = json.loads(json.dumps(art))
    tt, d, c = cell
    tampered["table"][tt][d][c] += 1
    edited = dict(art, n_microbatches=art["n_microbatches"] + 1)
    cases = [tampered, edited, dict(art, table=[[[0] * 3]]),
             dict(art, orders=[[[0, "X", 0]]] * art["n_devices"]),
             dict(art, artifact_version=9), dict(art, placement="ring"),
             dict(art, table_report={"ok": False})]
    for case in cases:
        msg = _load_error(tsch, case)
        assert msg == _load_error(jsch, case)
    assert f"(device {d}, tick {tt}, COL_FWD_SLOT)" in _load_error(
        tsch, tampered)
    assert "stale fingerprint" in _load_error(tsch, edited)


def test_registered_artifact_is_pinned(searched):
    """A registered artifact compiles to its certified table under its
    name (``ScheduleConfig.from_artifact``); an order function
    re-registered under that name no longer compiles; unregistering
    clears the pin."""
    _, t = searched[0]
    name = "SearchedPinTest"
    sched = port.ScheduleConfig.from_artifact(t.artifact, name=name)
    try:
        assert (sched.n_microbatches, sched.n_virtual) == (4, 1)
        info = tsch.registered_artifact_info(name)
        assert info["table_digest"] == t.artifact["table_digest"]
        cs = tsch.compile_schedule(name, 4, 1, 4)
        assert np.array_equal(cs.table, t.cs.table)
        with pytest.raises(tsch.ScheduleError, match="certified for"):
            tsch.compile_schedule(name, 4, 1, 8)
        tsch.register_schedule(
            name, lambda D, V, M: tsch.build_order("ZBH1", D, V, M),
            split_backward=True, overwrite=True)
        with pytest.raises(tsch.ScheduleError, match="artifact pin"):
            tsch.compile_schedule(name, 4, 1, 4)
    finally:
        tsch.unregister_schedule(name)
    assert tsch.registered_artifact_info(name) is None


def test_search_entry_point(tmp_path, capsys):
    """``python -m ...search_schedule`` writes a certified artifact that
    reloads, and a second search gives the same bytes."""
    assert tsearch_main.main([str(tmp_path), "--devices", "4",
                              "--microbatches", "4", "--iterations", "30"]) == 0
    cs = tsch.load_schedule_artifact(str(tmp_path / "searched_schedule.json"))
    assert cs.n_devices == 4 and cs.split_backward
    assert "artifact ->" in capsys.readouterr().out


def test_hooks_raise_as_jax(monkeypatch):
    """``DTPP_VERIFY_TABLES`` parsing, and each hook's message on a
    hazardous input, are JAX's."""
    for value, on in (("", False), ("0", False), ("off", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("DTPP_VERIFY_TABLES", value)
        assert tanalysis.verify_tables_enabled() is on
        assert janalysis.verify_tables_enabled() is on
    monkeypatch.setenv("DTPP_VERIFY_TABLES", "1")
    jcs, tcs = _both("GPipe", 2, 1, 4)
    table = np.array(tcs.table, copy=True)
    _m_spurious_store(table, tcs)
    pairs = [
        (lambda: janalysis.maybe_verify_schedule(_mutated(jcs, table)),
         lambda: tanalysis.maybe_verify_schedule(_mutated(tcs, table))),
        (lambda: janalysis.maybe_verify_serving(4, 2),
         lambda: tanalysis.maybe_verify_serving(4, 2)),
        (lambda: janalysis.maybe_verify_serving(2, 4, gamma=4,
                                                prefill_chunk=2),
         lambda: tanalysis.maybe_verify_serving(2, 4, gamma=4,
                                                prefill_chunk=2)),
        (lambda: janalysis.maybe_verify_page_table(
            [1, 1], refcount=np.ones(4, int), n_pages=4, page_size=2,
            write_lo=0, write_hi=4),
         lambda: tanalysis.maybe_verify_page_table(
            [1, 1], refcount=np.ones(4, int), n_pages=4, page_size=2,
            write_lo=0, write_hi=4)),
    ]
    ft, fn = tfwd_table(2, 1, 4)
    bad = np.array(ft, copy=True)
    bad[_find(ft, lambda r: r[0] >= 0)[0], 1, 0] = -1
    pairs.append((lambda: janalysis.maybe_verify_forward_table(bad, 2, 1, 4,
                                                               fn),
                  lambda: tanalysis.maybe_verify_forward_table(bad, 2, 1, 4,
                                                               fn)))
    for jfn, tfn in pairs:
        with pytest.raises(ValueError) as je:
            jfn()
        with pytest.raises(ValueError) as te:
            tfn()
        assert str(te.value) == str(je.value)
    tanalysis.maybe_verify_schedule(tcs)  # clean: silent
    monkeypatch.setenv("DTPP_VERIFY_TABLES", "0")
    tanalysis.maybe_verify_schedule(_mutated(tcs, table))  # off: silent


@pytest.mark.parametrize("name,L,D", [("1F1B", 8, 4), ("ZBV", 8, 2),
                                      ("Interleaved1F1B", 8, 2)])
def test_models_take_the_report(name, L, D):
    """``cost_model_section`` and ``memory_model_section`` with a
    precomputed report give the sections they compute without one, and
    JAX's with JAX's report: the hop count and the slot peaks are the
    verifier's."""
    V = virtual_stages_for(name, L, D)
    jcs, tcs = _both(name, D, V, 4)
    jrep, trep = jtc.check_table(jcs), ttc.check_table(tcs)
    hw = dict(name="h100", peak_flops=989e12, ici_bytes_per_s=3.35e12,
              hbm_bytes_per_s=3.35e12, hbm_bytes=80e9)
    kw = dict(batch_size=32, seq_length=128)
    jcfg = dtpp.ModelConfig(n_layers=L, n_heads=8)
    tcfg = port.ModelConfig(n_layers=L, n_heads=8)
    thw, jhw = tcm.HardwareSpec(**hw), jcm.HardwareSpec(**hw)
    t = tcm.cost_model_section(tcs, tcfg, hardware=thw, table_report=trep,
                               **kw)
    assert t == tcm.cost_model_section(tcs, tcfg, hardware=thw, **kw)
    j = jcm.cost_model_section(jcs, jcfg, hardware=jhw, table_report=jrep,
                               **kw)
    assert t["comm"]["hops"] == j["comm"]["hops"] == trep.predicted_ppermutes
    assert t["predicted"]["step_s"] == j["predicted"]["step_s"]
    tm = tmm.memory_model_section(tcs, tcfg, hardware=thw, table_report=trep,
                                  **kw)
    assert tm == tmm.memory_model_section(tcs, tcfg, hardware=thw, **kw)
    jm = jmm.memory_model_section(jcs, jcfg, hardware=jhw, table_report=jrep,
                                  **kw)
    analytic = dict(tm["analytic"])
    analytic.pop("card_bytes")
    assert analytic == jm["analytic"]
    assert [r["act_live_peak"] for r in tm["analytic"]["per_device"]] == \
        trep.act_live_peak
