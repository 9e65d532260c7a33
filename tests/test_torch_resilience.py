"""The PyTorch port's resilience, checkpoint and data modules against the
JAX package's, on the CPU.

Bit-identical: the forward-only tick table (``_fwd_tick_table``) over the
training tables' (D, V, M) grid; ``synthetic_batches``,
``TokenFileDataset`` and the native C++ loader's batches for one seed and
one file; ``latest_committed_step_dir`` and ``gc_checkpoints`` on the same
trees of markers and shells (legacy, partial and mismatched ones
included); the per-stage non-finite count; the config fingerprint.
Port-internal: the commit protocol of ``CheckpointManager`` with async
saves (the snapshot is taken at the save, not at the write), the
structural digest, the fault plan, the preemption handler, the watchdog,
and the device prefetch on the CPU."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    pipeline as jpipeline)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    checkpoint as jcheckpoint, data as jdata, data_native as jdata_native,
    dynamics as jdynamics, resilience as jresilience)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    pipeline as tpipeline)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    checkpoint as tcheckpoint, data as tdata, data_native as tdata_native,
    dynamics as tdynamics, resilience as tresilience)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [(1, 1, 1), (1, 1, 3), (2, 1, 1), (2, 1, 4), (3, 1, 2), (3, 1, 5),
        (4, 1, 4), (4, 1, 8), (2, 2, 4), (4, 2, 8), (2, 3, 6), (4, 2, 3)]


@pytest.mark.parametrize("D,V,M", GRID)
def test_fwd_tick_table_bit_identical(D, V, M):
    """The eval executor's [T, D, 4] table and slot count, every cell."""
    want, want_slots = jpipeline._fwd_tick_table(D, V, M)
    got, got_slots = tpipeline._fwd_tick_table(D, V, M)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got_slots == want_slots


def test_synthetic_batches_bit_identical():
    for next_tok in (True, False):
        j = jdata.synthetic_batches(97, 3, 8, seed=5,
                                    next_token_targets=next_tok)
        t = tdata.synthetic_batches(97, 3, 8, seed=5,
                                    next_token_targets=next_tok)
        for _ in range(3):
            for a, b in zip(next(j), next(t)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    """A seeded uint16 token file, written by the JAX ``write_token_file``
    (and byte-equal to the port's)."""
    d = tmp_path_factory.mktemp("tokens")
    toks = np.random.default_rng(0).integers(0, 50000, 5000)
    path, path2 = str(d / "j.bin"), str(d / "t.bin")
    jdata.write_token_file(path, toks)
    tdata.write_token_file(path2, toks)
    with open(path, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read()
    return path


def test_token_file_batches_bit_identical(token_file, tmp_path):
    j = jdata.TokenFileDataset(token_file, 16, seed=3).batches(4)
    t = tdata.TokenFileDataset(token_file, 16, seed=3).batches(4)
    for _ in range(3):
        for a, b in zip(next(j), next(t)):
            np.testing.assert_array_equal(a, b)
    side = tmp_path / "c.bin"
    side.write_bytes(b"")
    (tmp_path / "c.bin.meta.json").write_text(json.dumps({"dtype": "uint32"}))
    assert tdata.token_file_dtype(str(side)) == \
        jdata.token_file_dtype(str(side)) == np.uint32
    with pytest.raises(ValueError, match="need at least"):
        tdata.TokenFileDataset(token_file, 6000)


def test_native_loader_bit_identical(token_file):
    """One thread each: the port's loader, built from its own copy of the
    source, yields the JAX package's batches."""
    with open(os.path.join(ROOT, "csrc", "data_loader.cpp"), "rb") as f:
        assert f.read() == tdata_native.SOURCE.read_bytes()
    with jdata_native.NativeTokenLoader(token_file, 16, 4, seed=7,
                                        n_threads=1) as jl, \
            tdata_native.NativeTokenLoader(token_file, 16, 4, seed=7,
                                           n_threads=1) as tl:
        for _ in range(4):
            for a, b in zip(jl.next(), tl.next()):
                assert b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="need at least"):
        tdata_native.NativeTokenLoader(token_file, 6000, 1)


def test_unported_data_parts_raise(tmp_path):
    """``batch_sharding`` gives each rank of a 2 x 4 world the rows the JAX
    ``P(DATA_AXIS)`` split puts on the device at its coordinates of the
    simulated mesh, through the loaders and the prefetch alike;
    ``encode_text_file_hf`` (ported since) writes the JAX function's
    bytes for a tokenizer object."""
    import jax
    from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
        make_mesh)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.mesh import (
        Mesh)
    jmesh = make_mesh(n_pipe=4, n_data=2)
    x = np.arange(8 * 3).reshape(8, 3)
    placed = jax.device_put(x, jdata.batch_sharding(jmesh))
    rows = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    stream = tdata.synthetic_batches(97, 8, 5, seed=3)
    whole = [next(stream) for _ in range(2)]
    for k in range(2):
        for p in range(4):
            rank = Mesh(4, 2, k * 4 + p, "gloo", torch.device("cpu"))
            shard = tdata.batch_sharding(rank)
            np.testing.assert_array_equal(shard((x,))[0],
                                          rows[jmesh.devices[k, p]])
            got = tdata.synthetic_batches(97, 8, 5, seed=3, sharding=shard)
            fetched = tdata.prefetch_to_device(
                tdata.synthetic_batches(97, 8, 5, seed=3), device="cpu",
                sharding=shard)
            for (t, y), (ft, fy), (wt, wy) in zip(got, fetched, whole):
                np.testing.assert_array_equal(t, wt[4 * k:4 * k + 4])
                np.testing.assert_array_equal(y, wy[4 * k:4 * k + 4])
                np.testing.assert_array_equal(ft.numpy(), t)
                np.testing.assert_array_equal(fy.numpy(), y)
    with pytest.raises(ValueError, match="does not split"):
        tdata.BatchSharding(3, 0).rows(x)

    class CharTok:
        def __len__(self):
            return 97

        def __call__(self, text, add_special_tokens=True):
            return {"input_ids": [ord(c) % 97 for c in text
                                  if not c.isspace()]}

    src = tmp_path / "t.txt"
    src.write_text("pipeline stages\nhand off activations " * 5)
    for mod, out in ((jdata, tmp_path / "j.bin"), (tdata, tmp_path / "t.bin")):
        assert mod.encode_text_file_hf(str(src), str(out), CharTok(),
                                       chunk_chars=9) == 160
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()


def test_file_loaders_take_the_rank_slice(token_file):
    """The token-file sampler and the native loader (one thread) yield the
    rank's rows of the global batches they yield without a sharding."""
    shard = tdata.BatchSharding(2, 1)
    plain = tdata.TokenFileDataset(token_file, 16, seed=7).batches(4)
    sliced = tdata.TokenFileDataset(token_file, 16, seed=7).batches(4, shard)
    with tdata_native.NativeTokenLoader(token_file, 16, 4, seed=7,
                                        n_threads=1) as a, \
            tdata_native.NativeTokenLoader(token_file, 16, 4, seed=7,
                                           n_threads=1) as b:
        native, native_sliced = a.batches(), b.batches(shard)
        for _ in range(3):
            for whole, part in ((next(plain), next(sliced)),
                                (next(native), next(native_sliced))):
                for w, q in zip(whole, part):
                    np.testing.assert_array_equal(q, w[2:])


def test_encode_text_file_matches_jax(tmp_path):
    src = tmp_path / "a.txt"
    src.write_text("pipeline stages\n")
    n = tdata.encode_text_file(str(src), str(tmp_path / "t.bin"))
    assert n == jdata.encode_text_file(str(src), str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


def test_prefetch_on_cpu_yields_tensors():
    it = tdata.prefetch_to_device(tdata.synthetic_batches(11, 2, 3), depth=2,
                                  device="cpu")
    x, y = next(it)
    assert isinstance(x, torch.Tensor) and x.shape == (2, 3)
    with pytest.raises(ValueError, match="depth"):
        next(tdata.prefetch_to_device(iter([]), depth=0, device="cpu"))


# --- checkpoint directory selection: the same trees on both sides ---------

# (name, [(step, kind)]): kind "c" committed, "s" uncommitted shell, "x" an
# unreadable (partial) marker, "f" committed under another fingerprint
TREES = [
    ("empty", []),
    ("committed", [(1, "c"), (3, "c"), (5, "c")]),
    ("newest_shell", [(1, "c"), (3, "c"), (5, "s")]),
    ("partial_marker", [(2, "c"), (4, "x")]),
    ("legacy", [(1, "s"), (2, "s"), (7, "s")]),
    ("old_shells", [(1, "s"), (2, "c"), (3, "s"), (4, "c"), (6, "s")]),
    ("fingerprint", [(1, "c"), (2, "f"), (3, "s")]),
    ("all_mismatched", [(1, "f"), (2, "f")]),
]


def _build_tree(root, spec, write_marker):
    os.makedirs(root, exist_ok=True)
    for step, kind in spec:
        path = os.path.join(root, f"step_{step}")
        os.makedirs(path)
        with open(os.path.join(path, "state.bin"), "wb") as f:
            f.write(b"x")
        if kind in ("c", "f"):
            write_marker(path, {"step": step, "digest": "d0",
                                "fingerprint": "fp" if kind == "c"
                                else "other"})
        elif kind == "x":
            with open(os.path.join(path, "_COMMITTED.json"), "w") as f:
                f.write("{partial")
    with open(os.path.join(root, "step_notanumber"), "w") as f:
        f.write("")


def _rel(res, root):
    return None if res is None else (res[0], os.path.relpath(res[1], root))


@pytest.mark.parametrize("name,spec", TREES, ids=[t[0] for t in TREES])
def test_checkpoint_selection_bit_identical(tmp_path, name, spec):
    """``latest_committed_step_dir`` (with and without the fingerprint and
    digest) and ``gc_checkpoints`` at keep 1 and 2 pick and remove the
    same dirs on both sides."""
    for keep in (1, 2):
        roots = {}
        for side, mod in (("j", jcheckpoint), ("t", tcheckpoint)):
            roots[side] = str(tmp_path / f"{side}{keep}")
            _build_tree(roots[side], spec, mod.write_commit_marker)
        for kw in ({}, {"fingerprint": "fp"}, {"digest": "d1"},
                   {"fingerprint": "fp", "digest": "d0"}):
            want = jresilience.latest_committed_step_dir(roots["j"], **kw)
            got = tresilience.latest_committed_step_dir(roots["t"], **kw)
            assert _rel(got, roots["t"]) == _rel(want, roots["j"]), kw
        assert tresilience.list_step_dirs(roots["t"]) == [
            (n, p.replace(roots["j"], roots["t"]))
            for n, p in jresilience.list_step_dirs(roots["j"])]
        want = jresilience.gc_checkpoints(roots["j"], keep)
        got = tresilience.gc_checkpoints(roots["t"], keep)
        assert [os.path.relpath(p, roots["t"]) for p in got] == \
            [os.path.relpath(p, roots["j"]) for p in want]
        assert sorted(os.listdir(roots["t"])) == sorted(os.listdir(roots["j"]))
    with pytest.raises(ValueError, match="keep_last"):
        tresilience.gc_checkpoints(str(tmp_path), 0)


def test_commit_marker_format_matches_jax(tmp_path):
    meta = {"step": 3, "fingerprint": "ab", "digest": "cd",
            "committed_unix": 1.5}
    for side, mod in (("j", jcheckpoint), ("t", tcheckpoint)):
        os.makedirs(tmp_path / side)
        mod.write_commit_marker(str(tmp_path / side), meta)
    assert (tmp_path / "t" / "_COMMITTED.json").read_bytes() == \
        (tmp_path / "j" / "_COMMITTED.json").read_bytes()
    assert tcheckpoint.read_commit_marker(str(tmp_path / "j")) == meta
    assert tcheckpoint.COMMIT_MARKER == jcheckpoint.COMMIT_MARKER


def test_config_fingerprint_matches_jax():
    objs = ({"pipe": 4, "data": 1}, [1, 2.5, "x"], None)
    assert tresilience.config_fingerprint(*objs) == \
        jresilience.config_fingerprint(*objs)
    assert tresilience.config_fingerprint(port.ScheduleConfig("1F1B", 4)) \
        != tresilience.config_fingerprint(port.ScheduleConfig("GPipe", 4))


def test_nonfinite_per_stage_matches_jax():
    """Non-finite (leaf, layer) units per stage over a GPT-2 gradient tree
    with NaN and inf planted in layer, embedding and head leaves."""
    L, d, f, v = 4, 8, 16, 11
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def lin(i, o):
        return {"w": r(L, i, o), "b": r(L, o)}

    def ln():
        return {"scale": r(L, d), "bias": r(L, d)}

    tree = {"embed": {"tok": r(v, d), "pos": r(16, d)},
            "layers": {"ln1": ln(), "ln2": ln(),
                       "attn": {n: lin(d, d) for n in "qkvo"},
                       "lin1": lin(d, f), "lin2": lin(f, d)},
            "head": {"norm": {"scale": r(d), "bias": r(d)},
                     "out": {"w": r(d, v)}}}
    tree["layers"]["attn"]["q"]["w"][1, 2, 3] = np.nan
    tree["layers"]["lin2"]["b"][1, 0] = np.inf
    tree["layers"]["ln2"]["scale"][3, 1] = -np.inf
    tree["embed"]["pos"][0, 0] = np.nan
    tree["head"]["out"]["w"][0, 0] = np.nan
    cfg = port.gpt2_config("small", dim=d, n_layers=L, n_heads=2,
                           vocab_size=v, ffn_dim=f, max_seq_len=16)
    model = port.from_jax_params(cfg, tree, device="cpu")
    for p in model.parameters():
        p.grad = p.detach().clone()
    for S in (1, 2, 4):
        want = np.asarray(jdynamics.nonfinite_per_stage(L, S, tree))
        got = tdynamics.nonfinite_per_stage(L, S, model)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# --- port-internal: commit protocol, async saves, faults -------------------


def _state(x):
    return {"model": {"w": x}, "optimizer": {"state": {0: {"m": x * 2}},
                                             "param_groups": [{"lr": 0.1}]},
            "step": 3, "guard": None}


def test_async_save_snapshots_before_in_place_update(tmp_path):
    """An async save holds the values at the save even when the tensor is
    updated in place before the write lands; the commit marker appears
    only at ``commit_pending``, with the JAX marker keys."""
    mgr = tresilience.CheckpointManager(str(tmp_path), fingerprint="fp")
    x = torch.arange(6.0)
    path = mgr.save(4, _state(x), wait=False)
    x.add_(100.0)  # the next step's in-place update
    mgr.commit_pending()
    marker = tcheckpoint.read_commit_marker(path)
    assert set(marker) == {"step", "fingerprint", "digest", "committed_unix"}
    assert marker["step"] == 4 and marker["fingerprint"] == "fp"
    n, p, state = mgr.restore_latest(_state(torch.zeros(6)))
    assert (n, p) == (4, path)
    assert torch.equal(state["model"]["w"], torch.arange(6.0))
    assert torch.equal(state["optimizer"]["state"][0]["m"],
                       2 * torch.arange(6.0))
    assert state["step"] == 3 and mgr.stats()["n_committed"] == 1


def test_kill_in_save_leaves_a_shell_resume_skips(tmp_path):
    plan = tresilience.FaultPlan(kill_in_save_step=6)
    mgr = tresilience.CheckpointManager(str(tmp_path), fault_plan=plan,
                                        keep_last=1)
    mgr.save(2, _state(torch.ones(3)))
    mgr.save(4, _state(torch.full((3,), 4.0)), wait=False)
    with pytest.raises(tresilience.SimulatedKill):
        mgr.save(6, _state(torch.full((3,), 6.0)))
    assert not tcheckpoint.is_committed(mgr.step_path(6))
    assert os.path.exists(os.path.join(mgr.step_path(6), "state.pt"))
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_6"]  # GC kept 1
    fresh = tresilience.CheckpointManager(str(tmp_path))
    n, _, state = fresh.restore_latest(_state(torch.zeros(3)))
    assert n == 4 and torch.equal(state["model"]["w"], torch.full((3,), 4.0))
    fresh.save(6, _state(torch.full((3,), 7.0)))  # re-saves over the shell
    assert tcheckpoint.is_committed(fresh.step_path(6))
    with pytest.raises(ValueError, match="refusing to overwrite"):
        tcheckpoint.save_checkpoint(fresh.step_path(6), _state(torch.ones(3)))


def test_digest_is_structural_and_skips_mismatches(tmp_path):
    a, b = _state(torch.zeros(3)), _state(torch.ones(3))
    assert tresilience.pytree_digest(a) == tresilience.pytree_digest(b)
    assert tresilience.pytree_digest(a) != \
        tresilience.pytree_digest(_state(torch.zeros(4)))
    assert tresilience.pytree_digest(a) != \
        tresilience.pytree_digest(_state(torch.zeros(3, dtype=torch.int32)))
    mgr = tresilience.CheckpointManager(str(tmp_path))
    mgr.save(1, a)
    assert mgr.restore_latest(_state(torch.zeros(5))) is None
    assert mgr.save(1, b) == mgr.step_path(1)  # same digest: left alone


def test_fault_plan_wrap_data_and_guard_state():
    plan = tresilience.FaultPlan(data_fail_step=2)
    it = plan.wrap_data(iter(range(5)))
    assert [next(it), next(it)] == [0, 1]
    with pytest.raises(tresilience.InjectedDataFault):
        next(it)
    assert tresilience.FaultPlan().wrap_data("x") == "x"
    gs = tresilience.init_guard_state(7, device="cpu")
    assert {k: int(v) for k, v in gs.items()} == {
        "step": 7, "consec": 0, "total": 0, "last_anomaly_step": -1,
        "last_bad_stage": -1}
    assert all(v.dtype == torch.int32 for v in gs.values())


def test_preemption_handler_and_watchdog():
    with tresilience.PreemptionHandler() as h:
        assert not h.triggered
        signal.raise_signal(signal.SIGTERM)
        assert h.triggered and h.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is not h._on
    h2 = tresilience.PreemptionHandler(enabled=False)
    h2.trigger()
    assert h2.triggered
    fired = threading.Event()
    seen = []

    def on_stall(info):
        seen.append(info)
        fired.set()

    dog = tresilience.StepWatchdog(0.05, on_stall, poll_s=0.01)
    try:
        dog.beat(3)
        assert fired.wait(5.0)
    finally:
        dog.stop()
    assert not dog._thread.is_alive()
    assert dog.stalls >= 1 and seen[0]["step"] == 3
    with pytest.raises(ValueError, match="timeout_s"):
        tresilience.StepWatchdog(0, on_stall)
