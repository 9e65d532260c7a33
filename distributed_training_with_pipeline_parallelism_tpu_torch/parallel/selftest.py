"""A world's self-test: gradient, ZeRO-1, eval and ``fit`` cases run on
every rank of a :func:`.mesh.launch` world, the results written as
``.npz`` files for the launcher to compare with the lockstep transport and
the JAX mesh.

    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        mesh, selftest)
    mesh.launch(selftest.run_cases, MeshConfig(2, 2), spec,
                backend="gloo", device="cpu")

``spec`` holds the model's config fields (``"cfg"``), its weights as a
JAX-layout pytree of numpy arrays per tie setting (``"trees"``:
``{False: untied, True: tied}``), a global batch (``"tokens"``,
``"targets"``), the output directory (``"out"``), the torch thread count
(``"threads"``) and the cases. A case may name other config fields
(``"cfgs"[case["cfg"]]``), its weights (``"trees"[case["tree"]]``) and
its global batch (``"batches"[case["batch"]]``, a (tokens, targets)
pair).
Its mesh is (``"n_pipe"``, ``"n_data"``, ``"n_model"``, the last 1 by
default); with a model axis each rank holds its Megatron shard
(``tensor_parallel.shard_model``, the head split over the vocab with
``"vocab_parallel"``), and a ``"grad"`` case also records the model-ring
hops the step posted (``"hops"``) and, with ``"seed"``, runs dropout
under that step seed. Each case is a dict with ``"name"``, ``"kind"`` and
its fields:

- ``"grad"``: one step of ``make_pipeline_grad_fn`` on a (``"n_data"`` x
  ``"n_pipe"``) mesh under ``"schedule"`` (``"n_virtual"``, ``"M"``,
  ``"comm_overlap"``, ``"tied"``): ``{name}_r{rank}.npz`` holds the loss
  and the rank's gradients by parameter name; with ``"lockstep": True``
  rank 0 also runs the same step over the lockstep transport on the whole
  model and batch (``{name}_lockstep.npz``). With ``"dynamics": True``
  the step returns ``sq_mb`` and the file also holds it and the world's
  ``dynamics.stage_stats`` (``"dyn/..."``); the lockstep step then runs
  ``"M"`` times ``n_data`` microbatches, the world's.
- ``"eval"``: ``make_pipeline_loss_fn`` on the mesh and, on rank 0, over
  the lockstep transport.
- ``"train"``: ``"steps"`` steps of ``make_train_step`` (``adamw`` with
  ``"opt"``'s fields) with ZeRO-1 and with plain AdamW from the same
  weights: the rank's parameters after each step and the clipping norm
  each update took; rank 0 also runs the lockstep step on the whole model
  and batch (``"M"`` times ``n_data`` microbatches, so the microbatches
  are the world's) and writes the same as ``{name}_lockstep.npz``.
- ``"tp_grad_fn"``: ``tensor_parallel.make_tp_grad_fn`` (the mesh's
  ``n_pipe`` is 1), the head split over the vocab.
- ``"fit"``: ``fit`` with the anomaly guard and a checkpoint a step
  (under ``{out}/{name}/``); rank ``"poison_rank"`` alone poisons its
  gradients at step ``"poison_step"``.

Every rank runs every case in order, so the collectives pair.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

from ..utils.config import ModelConfig, ScheduleConfig
from .mesh import Mesh, make_mesh


def _npz(path: str, loss, model=None, extra=None) -> None:
    arrays = {"loss": np.asarray(float(loss))}
    if model is not None:
        for n, p in model.named_parameters():
            if p.grad is not None:
                arrays[f"grad/{n}"] = p.grad.detach().cpu().numpy().copy()
    arrays.update(extra or {})
    np.savez(path, **arrays)


def _stamps(tel) -> Dict[str, np.ndarray]:
    """A stamped step's record: its spans as (kind, index, count) rows,
    its timeline's ticks and, on global rank 0, each rank's wait."""
    spans = tel.spans()
    return {"tel/spans": np.asarray(sorted((k, i, n) for (k, i), (_, _, n)
                                           in spans.items())),
            "tel/ticks": np.asarray([r["tick"] for r in tel.timeline()]),
            "tel/wait_s": np.asarray([r["wait_s"]
                                      for r in tel.rank_summary()])}


def _params(model) -> Dict[str, np.ndarray]:
    return {f"param/{n}": p.detach().cpu().numpy().copy()
            for n, p in model.named_parameters()}


def record_norms(opt_state, norms: list):
    """``opt_state`` with its clipping norms appended to ``norms``."""
    inner = getattr(opt_state, "inner", opt_state)
    norm_of = inner.global_norm

    def global_norm(grads, mesh=None):
        norm = norm_of(grads, mesh)
        norms.append(float(norm))
        return norm

    inner.global_norm = global_norm
    return opt_state


def _train(step, model, opt_state, steps: int, batch, label: str) -> dict:
    """``steps`` train steps: the parameters after each and the norms."""
    norms, out = [], {}
    record_norms(opt_state, norms)
    for i in range(steps):
        step(model, opt_state, *batch)
        out.update({f"{label}/{i}/{k}": v for k, v in _params(model).items()})
    out[f"{label}/norms"] = np.asarray(norms)
    return out


def fail_on_rank(world: Mesh, rank: int) -> None:
    """Rank ``rank`` raises; the others wait in a barrier until the
    launcher stops them (the launcher's failure path)."""
    if world.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    world.barrier()


def ring_blocks(mesh: Mesh) -> dict:
    """On a model axis of 2 or more: the ring's all-gather matmul against
    the unfused all-gather then matmul (equal?), its reduce-scatter
    against the unfused one (max abs error) and the hops the two rings
    posted, on seeded [2, 4 T, 16] inputs."""
    from ..ops import collectives as col
    from .tensor_parallel import tp_all_gather_matmul, tp_matmul_reduce_scatter
    torch.set_num_threads(1)
    T, my = mesh.n_model, mesh.model
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4 * T, 16, generator=g)
    w_up = torch.randn(8 * T, 16, generator=g)[my * 8:(my + 1) * 8]
    z = torch.randn(2, 4 * T, 8, generator=g)
    w_dn = torch.randn(16, 8 * T, generator=g)[:, my * 8:(my + 1) * 8]
    x_loc = col.seq_scatter(x, mesh)
    hops = mesh.hops
    ring_up = tp_all_gather_matmul(x_loc, w_up, mesh, "ring")
    ring_dn = tp_matmul_reduce_scatter(z, w_dn, mesh, "ring")
    hops = mesh.hops - hops
    up = tp_all_gather_matmul(x_loc, w_up, mesh, "none")
    dn = tp_matmul_reduce_scatter(z, w_dn, mesh, "none")
    return {"rank": mesh.rank, "gather_equal": torch.equal(ring_up, up),
            "scatter_err": float((ring_dn - dn).abs().max()), "hops": hops}


def _dynamics(cfg, sched, D, model, sq_mb, mesh) -> Dict[str, np.ndarray]:
    """``sq_mb`` and the stage statistics of the model's gradients (over
    a world: the replicated leaves counted on pipe coordinate 0)."""
    from ..utils.dynamics import stage_stats
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None
             and (mesh is None or mesh.pipe == 0 or n.startswith("layers."))}
    st = stage_stats(cfg.n_layers, D * sched.n_virtual, grads, mesh=mesh)
    st["sq_mb"] = sq_mb
    return {f"dyn/{k}": v.detach().cpu().numpy() for k, v in st.items()}


def run_cases(world: Mesh, spec: dict) -> dict:
    """Run ``spec``'s cases on this rank (see the module doc); returns
    ``{"rank": r, "seconds": {case: s}, "modules": [top-level modules
    this process imported]}``."""
    import time

    from ..utils import train as ttrain
    from ..utils.data import batch_sharding, synthetic_batches
    from ..utils.resilience import FaultPlan
    from ..utils.telemetry import PipelineTelemetry
    from ..utils.weights import from_jax_params
    from .pipeline import (make_pipeline_grad_fn, make_pipeline_loss_fn,
                           owned_layers)
    from .tensor_parallel import TPShard, make_tp_grad_fn

    torch.set_num_threads(spec.get("threads", 1))
    device = world.device
    meshes = {}

    def mesh_of(case):
        shape = (case["n_pipe"], case["n_data"], case.get("n_model", 1))
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, backend=world.backend,
                                      device=device)
        return meshes[shape]

    out, rank = spec["out"], world.rank
    seconds = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        name, kind = case["name"], case["kind"]
        mesh = mesh_of(case)
        if "cfg" in case:
            cfg = ModelConfig(**spec["cfgs"][case["cfg"]])
        else:
            cfg = ModelConfig(**spec["cfg"],
                              tie_embeddings=case.get("tied", False))
        tree = spec["trees"][case.get("tree", cfg.tie_embeddings)]
        sched = ScheduleConfig(case["schedule"], case["M"],
                               case.get("n_virtual", 1))
        vp = case.get("vocab_parallel", False)
        tp = (TPShard(mesh.n_model, mesh.model, vp) if mesh.n_model > 1
              else None)
        seed = () if "seed" not in case else (case["seed"],)
        D = mesh.n_pipe
        own = owned_layers(cfg.n_layers, sched, D, mesh.pipe)
        shard = batch_sharding(mesh)
        batch = (spec["batches"][case["batch"]] if "batch" in case
                 else (spec["tokens"], spec["targets"]))
        tokens, targets = (torch.from_numpy(x) for x in batch)
        local = shard((tokens, targets))
        view = from_jax_params(cfg, tree, device=device, layers=own,
                               shard=tp)
        if kind == "grad":
            tel = PipelineTelemetry() if case.get("telemetry") else None
            dyn = case.get("dynamics", False)
            fn = make_pipeline_grad_fn(cfg, sched, D, device=device,
                                       mesh=mesh,
                                       comm_overlap=case["comm_overlap"],
                                       tp_vocab_parallel=vp, telemetry=tel,
                                       dynamics=dyn)
            hops = mesh.hops
            loss = fn(view, *local, *seed)
            extra = {"hops": np.asarray(mesh.hops - hops)}
            if dyn:
                loss, sq_mb = loss
                extra.update(_dynamics(cfg, sched, D, view, sq_mb, mesh))
            if tel is not None:
                extra.update(_stamps(tel))
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, view,
                 extra=extra)
            if case.get("lockstep") and rank == 0:
                whole = from_jax_params(cfg, tree, device=device)
                lsched = sched if not dyn else ScheduleConfig(
                    sched.name, sched.n_microbatches * mesh.n_data,
                    sched.n_virtual)
                ref = make_pipeline_grad_fn(cfg, lsched, D, device=device,
                                            dynamics=dyn)
                loss = ref(whole, tokens, targets, *seed)
                extra = {}
                if dyn:
                    loss, sq_mb = loss
                    extra = _dynamics(cfg, lsched, D, whole, sq_mb, None)
                _npz(os.path.join(out, f"{name}_lockstep.npz"), loss, whole,
                     extra=extra)
        elif kind == "tp_grad_fn":
            whole = from_jax_params(cfg, tree, device=device, shard=tp)
            loss = make_tp_grad_fn(cfg, mesh, device=device)(whole, *local)
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, whole)
        elif kind == "eval":
            loss = make_pipeline_loss_fn(cfg, sched, D, device=device,
                                         mesh=mesh)(view, *local)
            extra = {}
            if rank == 0:
                whole = from_jax_params(cfg, tree, device=device)
                extra["lockstep"] = np.asarray(float(make_pipeline_loss_fn(
                    cfg, sched, D, device=device)(whole, tokens, targets)))
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss,
                 extra=extra)
        elif kind == "train":
            opt = ttrain.adamw(**case["opt"])
            step = ttrain.make_train_step(cfg, sched, D, opt, device=device,
                                          mesh=mesh, tp_vocab_parallel=vp)
            other = from_jax_params(cfg, tree, device=device, layers=own,
                                    shard=tp)
            extra = _train(step, view, ttrain.init_sharded_opt_state(
                opt, view, mesh), case["steps"], local, "zero1")
            extra.update(_train(step, other, opt.init(other), case["steps"],
                                local, "plain"))
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), 0.0,
                 extra=extra)
            if rank == 0:
                whole = from_jax_params(cfg, tree, device=device)
                ref = ttrain.make_train_step(
                    cfg, ScheduleConfig(case["schedule"],
                                        case["M"] * mesh.n_data), D, opt,
                    device=device)
                _npz(os.path.join(out, f"{name}_lockstep.npz"), 0.0,
                     extra=_train(ref, whole, opt.init(whole),
                                  case["steps"], (tokens, targets),
                                  "lockstep"))
        elif kind == "fit":
            plan = FaultPlan(nan_grad_steps=(case["poison_step"],)
                             if rank == case["poison_rank"] else ())
            data = synthetic_batches(cfg.vocab_size, tokens.shape[0],
                                     tokens.shape[1], seed=1,
                                     sharding=shard)
            _, history = ttrain.fit(
                cfg, sched, D, view, data, case["steps"],
                optimizer=ttrain.adamw(warmup_steps=1), log_every=1,
                verbose=False, checkpoint_dir=os.path.join(out, name),
                checkpoint_every=1, guard=True, fault_plan=plan,
                device=device, mesh=mesh)
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), 0.0, extra={
                "history": np.asarray(history, dtype=np.float64)})
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        seconds[name] = time.perf_counter() - t0
    return {"rank": rank, "seconds": seconds,
            "modules": sorted({m.split(".")[0] for m in sys.modules})}
