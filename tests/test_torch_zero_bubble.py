"""The PyTorch port's zero-bubble schedules (ZBH1, ZBV: the split backward's
W units and the V placement) against the JAX package on the CPU.

- Tables: ``compile_schedule`` cell for cell, ``makespan``, slot counts,
  ``split_backward``, ``placement``, both bubble fractions, the simulated
  bubble under the split weights, ``async_makespan``,
  ``predicted_throughput`` and ``table_unit_activity`` over a grid of
  (D, V, M), and the same error type where the JAX package refuses one
  (pure numpy on both sides).
- Orders: ``validate_order`` refuses a W before its B on both sides; a
  split order registered under one name on both sides compiles to equal
  tables.
- Executor: the loss and every gradient leaf of ``make_pipeline_grad_fn``
  under ZBH1 (D = 2, 4) and ZBV (D = 2), tied and untied, against
  ``jax.value_and_grad`` of the JAX ``transformer_loss`` (the reference
  the JAX package's own zero-bubble tests hold its executors to), with
  ``test_torch_train.py``'s size, weights and tolerances and both kernel
  routes on (their plain versions on the CPU). The JAX zero-bubble
  executor itself is not compiled here (12-26 s each at this size).
- Dropout: ZBH1 at D = 2 gives 1F1B's loss and gradients on one step
  seed; the stored backward is refused under a split schedule.
- ``fit``, the entry point and a sweep row under the zero-bubble
  schedules, and ``init_guard_state``'s default device.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import (
    train as tmain)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    data as tdata, resilience as tresilience, sweep as tsweep,
    train as ttrain)
from test_torch_train import (B, GRAD_ATOL, GRAD_RTOL, LOSS_TOL, M, S,  # noqa: F401
                              _assert_grads_match, _cfgs, _one_torch_thread,
                              reference)

GRID = [("ZBH1", 2, 1, 2), ("ZBH1", 2, 1, 4), ("ZBH1", 3, 1, 3),
        ("ZBH1", 4, 1, 4), ("ZBH1", 4, 1, 8), ("ZBH1", 8, 1, 16),
        ("ZBV", 2, 2, 4), ("ZBV", 3, 2, 6), ("ZBV", 4, 2, 8),
        ("ZBV", 8, 2, 16),
        # refused: one device, M < D, V != 1 for ZBH1; V != 2, M < 2D,
        # one device for ZBV
        ("ZBH1", 1, 1, 4), ("ZBH1", 4, 1, 3), ("ZBH1", 2, 2, 4),
        ("ZBV", 2, 1, 4), ("ZBV", 2, 2, 3), ("ZBV", 1, 2, 4)]


@pytest.mark.parametrize("name,D,V,M_", GRID)
def test_zero_bubble_tables_bit_identical(name, D, V, M_):
    try:
        want = jsched.compile_schedule(name, D, V, M_)
    except jsched.ScheduleError as e:
        with pytest.raises(tsched.ScheduleError):
            tsched.compile_schedule(name, D, V, M_)
        assert isinstance(e, ValueError)
        return
    got = tsched.compile_schedule(name, D, V, M_)
    assert got.table.dtype == want.table.dtype == np.int32
    np.testing.assert_array_equal(got.table, want.table)
    assert (got.makespan, got.n_act_slots, got.n_grad_slots) == (
        want.makespan, want.n_act_slots, want.n_grad_slots)
    assert (got.split_backward, got.placement, got.uses_reverse_routes) == (
        want.split_backward, want.placement, want.uses_reverse_routes)
    assert got.split_backward and got.placement == (
        "vshape" if name == "ZBV" else "wrap")
    for fn in ("analytic_bubble_fraction", "paper_bubble_fraction",
               "async_makespan"):
        assert getattr(tsched, fn)(name, D, V, M_) == \
            getattr(jsched, fn)(name, D, V, M_), fn
    assert tsched.predicted_throughput(name, D, V, M_, 1024) == \
        jsched.predicted_throughput(name, D, V, M_, 1024)
    assert tsched.simulated_bubble(got, 1.0, 2.0, 2.0) == \
        jsched.simulated_bubble(want, 1.0, 2.0, 2.0)
    np.testing.assert_array_equal(tsched.table_unit_activity(got.table),
                                  jsched.table_unit_activity(want.table))


def test_validate_order_refuses_w_before_its_dgrad():
    """Swapping a W ahead of its B: both sides raise the same error
    class with the same location and reason."""
    errors = []
    for mod in (jsched, tsched):
        orders = mod.zb_h1_order(2, 2)
        acts = orders[1]
        i = next(k for k, a in enumerate(acts) if a.op == mod.B)
        j = acts.index(mod.Action(acts[i].stage, mod.W, acts[i].microbatch))
        acts[i], acts[j] = acts[j], acts[i]
        with pytest.raises(mod.ScheduleError, match="dgrad twin") as e:
            mod.validate_order(orders, 2, 1, 2, split_backward=True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.fixture
def registered():
    """One split order under the same name on both sides."""
    name = "PortZB"
    jsched.register_schedule(name, lambda D, V, M_: jsched.zb_h1_order(D, M_),
                             split_backward=True)
    tsched.register_schedule(name, lambda D, V, M_: tsched.zb_h1_order(D, M_),
                             split_backward=True)
    try:
        yield name
    finally:
        jsched.unregister_schedule(name)
        tsched.unregister_schedule(name)


def test_registered_split_order_compiles_alike(registered):
    got = tsched.compile_schedule(registered, 3, 1, 6)
    want = jsched.compile_schedule(registered, 3, 1, 6)
    np.testing.assert_array_equal(got.table, want.table)
    assert got.split_backward and tsched.is_custom(registered)
    assert registered in tsched.schedule_names()
    assert tsched.analytic_bubble_fraction(registered, 3, 1, 6, cs=got) == \
        jsched.analytic_bubble_fraction(registered, 3, 1, 6, cs=want)
    assert port.ScheduleConfig(registered, 6).name == registered
    with pytest.raises(tsched.ScheduleError, match="already exists"):
        tsched.register_schedule(registered, tsched.zb_h1_order)
    with pytest.raises(tsched.ScheduleError, match="built-in"):
        tsched.register_schedule("ZBH1", tsched.zb_h1_order, overwrite=True)


@pytest.mark.parametrize("name,D,V,tied", [
    ("ZBH1", 2, 1, False), ("ZBH1", 4, 1, False), ("ZBV", 2, 2, False),
    ("ZBH1", 2, 1, True), ("ZBV", 2, 2, True)])
def test_zero_bubble_grads_match_single_device(reference, name, D, V, tied):
    """Loss within 1e-5 and every gradient leaf within rtol 1e-4 / atol
    1e-6 of the single-device JAX objective, f32; tied, the token table
    takes stage 0's W and the last stage's W."""
    tree, tokens, targets, loss_ref, grads_ref = reference(tied)
    _, tcfg = _cfgs(tied)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    fn = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig(name, M, V), D,
                                    device="cpu")
    loss = fn(model, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(loss.item() - loss_ref) <= LOSS_TOL
    _assert_grads_match(tcfg, model, grads_ref)


def test_zero_bubble_dropout_matches_1f1b(reference):
    """Dropout 0.1 on one step seed: ZBH1 at D = 2 re-seeds the same
    streams in its F, B and W units, so it gives 1F1B's loss and
    gradients; ``remat_backward=False`` is refused under a split
    schedule."""
    tree, tokens, targets, _, _ = reference(False)
    _, tcfg = _cfgs(False)
    tcfg = dataclasses.replace(tcfg, dropout=0.1, use_flash_attention=False)
    out = {}
    for name in ("1F1B", "ZBH1"):
        model = port.from_jax_params(tcfg, tree, device="cpu")
        fn = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig(name, M),
                                        2, device="cpu")
        loss = fn(model, torch.from_numpy(tokens), torch.from_numpy(targets),
                  7)
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
    assert abs(out["ZBH1"][0] - out["1F1B"][0]) <= LOSS_TOL
    for n, g in out["1F1B"][1].items():
        np.testing.assert_allclose(out["ZBH1"][1][n].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    with pytest.raises(ValueError, match="split-backward"):
        port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig("ZBH1", M), 2,
                                   remat_backward=False, device="cpu")


def test_fit_under_zbh1_matches_1f1b(reference):
    """Two ``fit`` steps under ZBH1 equal two under 1F1B within 1e-5
    (loss history and parameters)."""
    tree, _, _, _, _ = reference(True)
    _, tcfg = _cfgs(True)
    runs = {}
    for name in ("1F1B", "ZBH1"):
        model = port.from_jax_params(tcfg, tree, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = ttrain.fit(
                tcfg, port.ScheduleConfig(name, M), 2, model,
                tdata.synthetic_batches(tcfg.vocab_size, B, S, seed=1), 2,
                optimizer=ttrain.adamw(learning_rate=1e-2, warmup_steps=1,
                                       total_steps=2),
                log_every=1, device="cpu")
        runs[name] = (hist, model)
    (h1, m1), (h2, m2) = runs["1F1B"], runs["ZBH1"]
    assert [s for s, _ in h1] == [s for s, _ in h2] == [0, 1]
    for (_, a), (_, b) in zip(h1, h2):
        assert abs(a - b) <= 1e-5 * abs(a)
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("argv", [["--schedule", "ZBH1", "--pipe", "2"],
                                  ["--schedule", "ZBV", "--pipe", "2"]])
def test_entry_point_trains_zero_bubble(argv):
    """``train.main`` under ZBH1 and ZBV (two V-placed chunks a device
    without ``--virtual``) on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tmain.main([
            "--model", "gpt2-small", "--layers", "4", "--dim", "32",
            "--heads", "2", "--vocab", "64", "--seq", "16", "--batch", "8",
            "--steps", "2", "--microbatches", "4", "--device", "cpu"]
            + argv) == 0
    text = out.getvalue()
    assert f"{argv[1]} M=4 V={2 if argv[1] == 'ZBV' else 1}" in text
    assert "final loss" in text


def test_sweep_row_under_zbv():
    """``run_one_experiment("ZBV")`` lifts M to 2D and reports the split
    backward's columns, equal to the JAX formulas."""
    row = tsweep.run_one_experiment(
        4, 2, 2, "ZBV", batch_size=8, seq_length=8, num_iterations=1,
        dim=16, vocab_size=32, n_microbatches=2, device="cpu")
    assert row["n_microbatches"] == 4 and row["n_virtual"] == 2
    assert row["backward_policy"] == "split" and row["bubble_sim_w_b"] == 2.0
    assert row["bubble_analytic"] == jsched.analytic_bubble_fraction(
        "ZBV", 2, 2, 4)
    cs = jsched.compile_schedule("ZBV", 2, 2, 4)
    assert row["bubble_simulated"] == jsched.simulated_bubble(
        cs, 1.0, 2.0, 2.0)["bubble_fraction"]
    assert np.isfinite(row["throughput"])


def test_init_guard_state_defaults_to_the_card(monkeypatch):
    """Without ``device`` the counters go to the card, as every entry
    point's tensors do; without one that raises rather than running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tresilience.init_guard_state(0)
    assert tresilience.init_guard_state(3, device="cpu")["step"].device == \
        torch.device("cpu")
