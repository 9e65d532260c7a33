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
(``"threads"``) and the cases. Each case is a dict with ``"name"``,
``"kind"`` and its fields:

- ``"grad"``: one step of ``make_pipeline_grad_fn`` on a (``"n_data"`` x
  ``"n_pipe"``) mesh under ``"schedule"`` (``"n_virtual"``, ``"M"``,
  ``"comm_overlap"``, ``"tied"``): ``{name}_r{rank}.npz`` holds the loss
  and the rank's gradients by parameter name; with ``"lockstep": True``
  rank 0 also runs the same step over the lockstep transport on the whole
  model and batch (``{name}_lockstep.npz``).
- ``"eval"``: ``make_pipeline_loss_fn`` on the mesh and, on rank 0, over
  the lockstep transport.
- ``"train"``: ``"steps"`` steps of ``make_train_step`` (``adamw`` with
  ``"opt"``'s fields) with ZeRO-1 and with plain AdamW from the same
  weights: the rank's parameters after each step and the clipping norm
  each update took; rank 0 also runs the lockstep step on the whole model
  and batch (``"M"`` times ``n_data`` microbatches, so the microbatches
  are the world's) and writes the same as ``{name}_lockstep.npz``.
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


def run_cases(world: Mesh, spec: dict) -> dict:
    """Run ``spec``'s cases on this rank (see the module doc); returns
    ``{"rank": r, "seconds": {case: s}, "modules": [top-level modules
    this process imported]}``."""
    import time

    from ..utils import train as ttrain
    from ..utils.data import batch_sharding, synthetic_batches
    from ..utils.resilience import FaultPlan
    from ..utils.weights import from_jax_params
    from .pipeline import (make_pipeline_grad_fn, make_pipeline_loss_fn,
                           owned_layers)

    torch.set_num_threads(spec.get("threads", 1))
    device = world.device
    meshes = {}

    def mesh_of(case):
        shape = (case["n_pipe"], case["n_data"])
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
        cfg = ModelConfig(**spec["cfg"], tie_embeddings=case.get("tied",
                                                                 False))
        tree = spec["trees"][cfg.tie_embeddings]
        sched = ScheduleConfig(case["schedule"], case["M"],
                               case.get("n_virtual", 1))
        D = mesh.n_pipe
        own = owned_layers(cfg.n_layers, sched, D, mesh.pipe)
        shard = batch_sharding(mesh)
        tokens, targets = (torch.from_numpy(spec[k]) for k in ("tokens",
                                                               "targets"))
        local = shard((tokens, targets))
        view = from_jax_params(cfg, tree, device=device, layers=own)
        if kind == "grad":
            fn = make_pipeline_grad_fn(cfg, sched, D, device=device,
                                       mesh=mesh,
                                       comm_overlap=case["comm_overlap"])
            loss = fn(view, *local)
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, view)
            if case.get("lockstep") and rank == 0:
                whole = from_jax_params(cfg, tree, device=device)
                ref = make_pipeline_grad_fn(cfg, sched, D, device=device)
                loss = ref(whole, tokens, targets)
                _npz(os.path.join(out, f"{name}_lockstep.npz"), loss, whole)
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
                                          mesh=mesh)
            other = from_jax_params(cfg, tree, device=device, layers=own)
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
