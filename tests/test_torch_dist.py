"""The port's ``torch.distributed`` transport on the CPU: a gloo world of 4
processes held to the JAX mesh and to the lockstep transport.

One world runs every case (``parallel.selftest.run_cases``, spawned by
``parallel.mesh.launch``, so the children import neither jax nor this
module); its results come back as ``.npz`` files. While it runs, the JAX
executor compiles on this process's simulated mesh. Weights and batches
are ``test_torch_train.py``'s (a 4-layer GPT-2 of width 32, from numpy
with a seed), with both kernel routes on (their plain versions here).

- D = 2 x n_data = 2 under GPipe, 1F1B and Interleaved1F1B (V = 2)
  against JAX ``make_pipeline_grad_fn`` on ``make_mesh(n_pipe=2,
  n_data=2)``: loss within 1e-5, each leaf within rtol 1e-4 / atol 1e-6;
  the data replicas agree bitwise.
- D = 4 x n_data = 1 under 1F1B and ZBH1 against the lockstep transport
  on the same weights and batch: bitwise (tied ``tok`` within 1e-6 of its
  largest element).
- ``comm_overlap="ring"`` bitwise equal to ``"none"`` (world and
  lockstep); ``overlap_bank_stages`` bit-identical to JAX's.
- A stamped step (1F1B, D = 2 x 2): bitwise the unstamped step on every
  rank; global rank 0 merges every rank's stamps (each (kind, index)
  stamped by the four ranks, a timeline of T ticks) and each rank's
  arrival wait.
- The eval over the transport. The world's train step, plain AdamW and
  ZeRO-1 with clipping active, against the lockstep train step on the
  whole model and batch: the clipping norm within 1e-5 relative, every
  parameter within ``test_torch_train.py``'s AdamW bounds; in a two-step
  run with one moving update, ZeRO-1 against plain AdamW within 1e-6
  relative (over more updates Adam amplifies the last bit of the norm,
  which the two sum in other orders, on leaves whose gradient is
  rounding noise). ``fit`` with the guard
  where one rank's gradients turn NaN at step 1: every rank skips it, its
  checkpoint equal to step 0's.
- The launcher: a rank's failure fails the launch with its traceback;
  the backend and device rules.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    make_pipeline_grad_fn as jax_grad_fn)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, pipeline as tpipe, schedules as tsched, selftest)
from test_torch_train import (B, GRAD_ATOL, GRAD_RTOL, LOSS_TOL, S, SIZE,  # noqa: F401
                              _cfgs, _numpy_params, _one_torch_thread)

DP = (("GPipe", 1), ("1F1B", 1), ("Interleaved1F1B", 2))
PP = ("1F1B", "ZBH1")
OVERLAP = ("none", "ring")
DP_M, PP_M = 2, 4  # microbatches of the local batch (B / n_data)
# (steps, adamw fields): test_torch_train.py's AdamW run with a clip every
# step takes, and a run of one moving update
TRAIN = {"train": (3, dict(learning_rate=3e-2, weight_decay=0.1,
                           warmup_steps=2, total_steps=6,
                           max_grad_norm=0.05)),
         "zero1": (2, dict(learning_rate=1e-2, warmup_steps=1,
                           max_grad_norm=0.5))}


def _cases():
    cases = [dict(name=f"dp_{s}_{co}", kind="grad", schedule=s, n_virtual=V,
                  M=DP_M, n_pipe=2, n_data=2, comm_overlap=co)
             for s, V in DP for co in OVERLAP]
    cases += [dict(name=f"pp_{s}_{tied}_{co}", kind="grad", schedule=s,
                   M=PP_M, n_pipe=4, n_data=1, comm_overlap=co, tied=tied,
                   lockstep=co == "none")
              for s in PP for tied in (False, True) for co in OVERLAP]
    common = dict(schedule="1F1B", M=DP_M, n_pipe=2, n_data=2)
    cases += [dict(name="stamped", kind="grad", comm_overlap="none",
                   telemetry=True, **common),
              dict(name="dynamics", kind="grad", comm_overlap="none",
                   dynamics=True, lockstep=True, **common),
              dict(name="eval", kind="eval", **common),
              dict(name="train", kind="train", steps=TRAIN["train"][0],
                   opt=TRAIN["train"][1], tied=True, **common),
              dict(name="zero1", kind="train", steps=TRAIN["zero1"][0],
                   opt=TRAIN["zero1"][1], **common),
              dict(name="fit", kind="fit", steps=3, poison_rank=1,
                   poison_step=1, **common)]
    return cases


def _batch():
    rng = np.random.default_rng(1)
    return tuple(rng.integers(0, SIZE["vocab_size"], (B, S))
                 for _ in range(2))


class _World:
    """The world's run in a thread of this process, joined on first
    use."""

    def __init__(self, out):
        self.out = out
        tokens, targets = _batch()
        _, tcfg = _cfgs(False)
        fields = {k: getattr(tcfg, k) for k in (*SIZE, "use_flash_attention",
                                               "use_fused_xent")}
        spec = dict(cfg=fields, trees={t: _numpy_params(0, t)
                                       for t in (False, True)},
                    tokens=tokens, targets=targets, out=str(out), threads=1,
                    cases=_cases())
        self._box = {}
        self.t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, args=(spec,))
        self._thread.start()

    def _run(self, spec):
        try:
            self._box["ranks"] = tmesh.launch(
                selftest.run_cases, port.MeshConfig(2, 2), spec,
                backend="gloo", device="cpu", timeout_s=120)
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e
        self._box["seconds"] = time.perf_counter() - self.t0

    def result(self):
        self._thread.join(timeout=300)
        assert not self._thread.is_alive(), "the world did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return self._box["ranks"]

    def rank(self, name, r):
        return dict(np.load(os.path.join(self.out, f"{name}_r{r}.npz")))

    def merged(self, name, world=4):
        """(loss, {param name: gradient}) over the ranks; a replicated
        leaf must be equal on every rank that holds it."""
        grads = {}
        for r in range(world):
            for k, v in self.rank(name, r).items():
                if not k.startswith("grad/"):
                    continue
                if k in grads and not k.startswith("grad/layers."):
                    np.testing.assert_array_equal(grads[k], v, err_msg=k)
                grads[k[len("grad/"):]] = v
        return float(self.rank(name, 0)["loss"]), grads


def _jax_mesh_grads(name, V):
    jcfg, _ = _cfgs(False)
    tokens, targets = _batch()
    fn = jax.jit(jax_grad_fn(jcfg, jax_make_mesh(n_pipe=2, n_data=2),
                             dtpp.ScheduleConfig(name, DP_M, V),
                             unroll_ticks=False))
    loss, grads = fn(jax.tree.map(jnp.asarray, _numpy_params(0, False)),
                     tokens, targets)
    return float(loss), jax.tree.map(np.asarray, grads)


def test_world_matches_jax_mesh_and_lockstep(tmp_path):
    """The whole world's cases (see the module doc); the JAX executor
    compiles while the world runs."""
    world = _World(tmp_path)
    _, tcfg = _cfgs(False)
    jax_ref = {name: _jax_mesh_grads(name, V) for name, V in DP}
    ranks = world.result()
    for r in ranks:
        assert not {"jax", "jaxlib", "distributed_training_with_pipeline_"
                    "parallelism_tpu"} & set(r["modules"]), r["modules"]

    # D = 2 x 2 against the JAX mesh; ring == none; replicas agree
    for name, _ in DP:
        loss, grads = world.merged(f"dp_{name}_none")
        jloss, jgrads = jax_ref[name]
        assert abs(loss - jloss) <= LOSS_TOL, name
        ref = port.from_jax_params(tcfg, jgrads, device="cpu")
        assert set(grads) == {n for n, _ in ref.named_parameters()}
        for n, p in ref.named_parameters():
            np.testing.assert_allclose(grads[n], p.detach().numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name}: {n}")
        ring_loss, ring = world.merged(f"dp_{name}_ring")
        assert ring_loss == loss
        for n in grads:
            np.testing.assert_array_equal(ring[n], grads[n], err_msg=n)
        for r in (0, 1):  # data replica 0's rank r against replica 1's
            a, b = (world.rank(f"dp_{name}_none", q) for q in (r, r + 2))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # D = 4 x 1 against the lockstep transport, bitwise
    for name in PP:
        for tied in (False, True):
            ref = dict(np.load(os.path.join(
                tmp_path, f"pp_{name}_{tied}_none_lockstep.npz")))
            for co in OVERLAP:
                loss, grads = world.merged(f"pp_{name}_{tied}_{co}")
                assert loss == float(ref["loss"]), (name, tied, co)
                assert set(grads) == {k[len("grad/"):] for k in ref
                                      if k.startswith("grad/")}
                for n, g in grads.items():
                    want = ref[f"grad/{n}"]
                    if tied and n == "tok":  # the pipe sum of two halves
                        assert np.abs(g - want).max() <= \
                            1e-6 * np.abs(want).max(), (name, co)
                    else:
                        np.testing.assert_array_equal(
                            g, want, err_msg=f"{name} {tied} {co}: {n}")

    # the stamped step: every rank's loss and leaves bitwise the unstamped
    # step's; rank 0 holds one span per (kind, index), stamped by all four
    # ranks, a timeline of T ticks and each rank's wait
    T = tsched.compile_schedule("1F1B", 2, 1, DP_M).table.shape[0]
    for r in range(4):
        got, want = world.rank("stamped", r), world.rank("dp_1F1B_none", r)
        for k in (k for k in want if k != "hops"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rank0 = world.rank("stamped", 0)
    assert rank0["tel/spans"].tolist() == sorted(
        [[0, 0, 4], [4, 0, 4]] + [[3, t, 4] for t in range(T)])
    assert rank0["tel/ticks"].tolist() == list(range(T))
    assert len(rank0["tel/wait_s"]) == 4 and (rank0["tel/wait_s"] >= 0).all()
    assert len(world.rank("stamped", 1)["tel/wait_s"]) == 0

    # dynamics: every rank's sq_mb is the pipe sum and data mean of its
    # microbatches' squared norms, the lockstep step's over the world's
    # 2 x 2 microbatches; the stage statistics are the lockstep's; the
    # loss and leaves are the plain step's bitwise
    ref = dict(np.load(tmp_path / "dynamics_lockstep.npz"))
    want = (ref["dyn/sq_mb"][:DP_M] + ref["dyn/sq_mb"][DP_M:]) / 2
    for r in range(4):
        got, plain = world.rank("dynamics", r), world.rank("dp_1F1B_none", r)
        np.testing.assert_allclose(got["dyn/sq_mb"], want, rtol=1e-5)
        for k in (k for k in ref if k.startswith("dyn/") and k != "dyn/sq_mb"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for k in (k for k in plain if k != "hops"):
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        assert got["dyn/nonfinite_per_stage"].tolist() == [0, 0]

    # the eval: every rank holds the global batch's loss
    lock = float(world.rank("eval", 0)["lockstep"])
    for r in range(4):
        assert abs(float(world.rank("eval", r)["loss"]) - lock) <= 1e-6

    # the world's train steps against the lockstep step: every rank's
    # parameters after every step (test_torch_train.py's AdamW bounds:
    # the k bias moves by rounding noise alone) and the clipping norms
    for name, (steps, opt) in TRAIN.items():
        ref = dict(np.load(tmp_path / f"{name}_lockstep.npz"))
        norms = ref["lockstep/norms"]
        assert len(norms) == steps and (norms > opt["max_grad_norm"]).all()
        for r in range(4):
            z = world.rank(name, r)
            for label in ("plain", "zero1"):
                np.testing.assert_allclose(z[f"{label}/norms"], norms,
                                           rtol=1e-5,
                                           err_msg=f"{name} rank {r} {label}")
                for i in range(steps):
                    prefix = f"{label}/{i}/param/"
                    for k in (k for k in z if k.startswith(prefix)):
                        n = k[len(prefix):]
                        atol = (2 * opt["learning_rate"] * i
                                if n.endswith("attn.k.bias") else 1e-4)
                        np.testing.assert_allclose(
                            z[k], ref[f"lockstep/{i}/param/{n}"], rtol=1e-5,
                            atol=atol,
                            err_msg=f"{name} rank {r} {label} step {i}: {n}")
            last = f"plain/{steps - 1}/"
            assert any(not np.array_equal(z[k], z["plain/0/" + k[len(last):]])
                       for k in z if k.startswith(last)), \
                f"{name}: the updates with a learning rate > 0 moved nothing"
    # ZeRO-1 against plain AdamW over the data group
    for r in range(4):
        z = world.rank("zero1", r)
        for k in (k for k in z if k.startswith("zero1/") and "/param/" in k):
            want = z["plain/" + k[len("zero1/"):]]
            assert np.abs(z[k] - want).max() <= 1e-6 * np.abs(want).max(), k

    # the guard: rank 1's NaN at step 1 skips the step on every rank
    ck = tmp_path / "fit"
    for d in (0, 1):
        states = [torch.load(ck / f"step_{i}" / f"state_pipe{d}.pt",
                             weights_only=True) for i in range(3)]
        for k, v in states[0]["model"].items():
            assert torch.equal(v, states[1]["model"][k]), k
        assert any(not torch.equal(v, states[2]["model"][k])
                   for k, v in states[1]["model"].items())
        guard = {k: int(v) for k, v in states[1]["guard"].items()}
        assert guard["total"] == 1 and guard["last_anomaly_step"] == 1
    assert sorted(os.listdir(ck / "step_2")) == [
        "_COMMITTED.json", "state_pipe0.pt", "state_pipe1.pt"]
    history = world.rank("fit", 0)["history"]
    assert history[:, 0].tolist() == [0, 1, 2]
    assert np.isfinite(history[:, 1]).all()


@pytest.mark.parametrize("name,D,V,M_", [
    ("GPipe", 4, 1, 8), ("1F1B", 4, 1, 4), ("1F1B", 2, 1, 8),
    ("Interleaved1F1B", 2, 2, 4), ("Interleaved1F1B", 4, 2, 8),
    ("BFS", 2, 2, 4), ("ZBH1", 4, 1, 8), ("ZBH1", 2, 1, 2),
    ("ZBV", 2, 2, 4), ("ZBV", 4, 2, 8)])
def test_overlap_bank_stages_bit_identical(name, D, V, M_):
    want = jsched.overlap_bank_stages(
        jsched.compile_schedule(name, D, V, M_).table)
    got = tsched.overlap_bank_stages(
        tsched.compile_schedule(name, D, V, M_).table)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert tsched.OVERLAP_CHANNELS == jsched.OVERLAP_CHANNELS


@pytest.mark.parametrize("name,D,V,tied", [
    ("1F1B", 4, 1, False), ("ZBH1", 4, 1, True), ("ZBV", 2, 2, False),
    ("Interleaved1F1B", 2, 2, True)])
def test_lockstep_ring_equals_none(name, D, V, tied):
    """The lockstep transport banks at the ring's stages with the same
    bits as at the top of the tick."""
    _, tcfg = _cfgs(tied)
    tokens, targets = (torch.from_numpy(x) for x in _batch())
    out = []
    for co in OVERLAP:
        model = port.from_jax_params(tcfg, _numpy_params(0, tied),
                                     device="cpu")
        fn = port.make_pipeline_grad_fn(
            tcfg, port.ScheduleConfig(name, 4, V), D, device="cpu",
            comm_overlap=co)
        out.append((fn(model, tokens, targets), model))
    (l0, m0), (l1, m1) = out
    assert torch.equal(l0, l1)
    for (n, p), q in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_child_failure_fails_the_launch():
    with pytest.raises(tmesh.WorldError, match="(?s)rank 1 of 2.*on purpose"):
        tmesh.launch(selftest.fail_on_rank, port.MeshConfig(2, 1), 1,
                     backend="gloo", device="cpu", timeout_s=60)


def test_backend_and_device_rules(monkeypatch):
    with pytest.raises(ValueError, match="choose one of"):
        tmesh.rank_device("cpu", "mpi", 0, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmesh.rank_device("cpu", "nccl", 0, 2)
    assert tmesh.rank_device("cpu", "gloo", 1, 2) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one CUDA device per rank"):
        tmesh.rank_device("cuda", "nccl", 0, 4)
    # gloo shares the card and stages: reported, never switched quietly
    assert tmesh.rank_device("cuda", "gloo", 3, 4) == torch.device("cuda", 0)
    mesh = tmesh.Mesh(2, 2, 3, "gloo", torch.device("cuda", 0))
    assert mesh.describe()["staging"] is True
    assert (mesh.data, mesh.pipe) == (1, 1)
    assert tmesh.Mesh(2, 2, 3, "gloo", torch.device("cpu")).staging is False
    with pytest.raises(RuntimeError, match="init_multihost"):
        tmesh.make_mesh(2, 2, backend="gloo", device="cpu")
    # the expert axis is a world axis now: it needs a joined world too
    with pytest.raises(RuntimeError, match="init_multihost"):
        tmesh.make_mesh(2, n_expert=2, backend="gloo", device="cpu")


def test_pipeline_refusals_and_rank_view():
    _, tcfg = _cfgs(False)
    sched = port.ScheduleConfig("1F1B", 4)
    with pytest.raises(NotImplementedError, match="mesh=make_mesh"):
        port.make_pipeline_grad_fn(tcfg, sched, 2, device="cpu",
                                   axes={"data": 2})
    with pytest.raises(ValueError, match="comm_overlap"):
        port.make_pipeline_grad_fn(tcfg, sched, 2, device="cpu",
                                   comm_overlap="always")
    mesh = tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="n_pipe=2"):
        port.make_pipeline_grad_fn(tcfg, sched, 4, device="cpu", mesh=mesh)
    # a rank's view: its stages' blocks, the whole model's values
    zbv = port.ScheduleConfig("ZBV", 4, 2)
    assert tpipe.owned_layers(4, zbv, 2, 0) == [0, 3]
    assert tpipe.owned_layers(4, port.ScheduleConfig("Interleaved1F1B", 4,
                                                     2), 2, 1) == [1, 3]
    whole = port.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    view = port.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                            layers=[0, 3])
    got = view.state_dict()
    assert {k.split(".")[1] for k in got if k.startswith("layers.")} == \
        {"0", "3"}
    for k, v in got.items():
        assert torch.equal(v, whole.state_dict()[k]), k
