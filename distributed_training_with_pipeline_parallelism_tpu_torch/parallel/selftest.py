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
Its mesh is (``"n_pipe"``, ``"n_data"``, ``"n_model"``, ``"n_seq"``,
``"n_expert"``, the last three 1 by default); with ``"moe"`` (a
``MoEConfig``'s fields) the weights are a JAX ``moe_lm_init`` tree and each
rank holds its ``MoELM`` view with its expert coordinate's block of the
experts (``from_jax_params(..., moe=, expert=)``), which the ``"grad"``
and ``"eval"`` cases run (their files then hold the expert stacks' blocks
and, for ``"grad"``, the expert all-to-alls the step posted, ``"a2a"``)
on any mesh: with a model axis, ``"fsdp"`` and a seq axis as below, the
Megatron and FSDP shards cut from the expert block;
with a model axis each rank holds its Megatron
shard (``tensor_parallel.shard_model``, the head split over the vocab
with ``"vocab_parallel"``), with ``"fsdp"`` its data coordinate's FSDP
shard of that (``fsdp.fsdp_shard_params``; the file then also holds each
sharded leaf's dim, ``"fsdp/{name}"``), and on a seq axis its chunk of
each sequence, under ``"sp_attn_impl"``; a ``"grad"`` case also records
the model-ring hops the step posted (``"hops"``) and, with ``"seed"``,
runs dropout under that step seed. Each case is a dict with ``"name"``,
``"kind"`` and its fields:

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
- ``"fsdp_fit"``: ``"steps"`` steps of ``fit`` with ``sgd(0.1)``, without
  and with ``fsdp`` (``replicated/``, ``fsdp/`` params), then the FSDP
  run again with a checkpoint a step, killed in the save of step
  ``"kill"`` and resumed to the end (``resumed/`` params); rank 0 also
  writes the whole model that ``checkpoint.restore_world_model`` reads
  from the last step dir (``whole/``).
- ``"fsdp_grad_fn"``: ``fsdp.make_fsdp_grad_fn`` (``"n_pipe"`` 1) on the
  rank's ``shard_params_fsdp`` copy of the whole model, with each
  leaf's dim.
- ``"sp_loss"``: ``seq_parallel.make_sp_loss_fn`` (``"n_pipe"`` 1) on
  the whole model and the rank's chunks, its gradients summed over the
  seq group.
- ``"forward"``: ``make_pipeline_forward`` on the rank's view (its
  Megatron shard under a model axis) and its data shard: the logits.
- ``"ep_loss"``: ``expert_parallel.make_ep_loss_fn`` (``"n_pipe"`` 1,
  an expert-only mesh) on the rank's expert shard of the whole model and
  its rows, its gradients reduced by ``ep_reduce_grads``.
- ``"moe_fit"``: ``"steps"`` steps of ``fit`` with ``sgd(0.1)`` and
  ``moe``, from a whole-expert view (``fit`` cuts it), then again with a
  checkpoint a step, killed in the save of step ``"kill"`` and resumed to
  the end (``resumed/`` params); the first run's params are ``plain/``
  (expert stacks as the rank's block), and ``adamw/`` those of 2 steps
  of ``adamw`` with ``"opt"``'s fields; rank 0 also writes the whole model
  that ``checkpoint.restore_world_model`` reads from the last step dir
  (``whole/``). With ``"fit_kw"`` (``{"zero1": True}`` or ``{"fsdp":
  True}``) the checkpointed and resumed runs pass them, ``par/`` holds
  the params of the unbroken run with them (FSDP shards, their dims
  ``fsdp/{name}``), ``plain/`` that run's without them, and with
  ``"adamw": True`` all three take ``adamw`` with ``"opt"``'s fields (no
  ``adamw/`` run).
- ``"attn"``: ``ring_attention`` and ``ulysses_attention`` (``"impl"``)
  on the rank's chunks of seeded q, k, v [``"b"``, ``"s"``, ``"h"``,
  ``"dh"``] (k, v with ``"h_kv"`` heads, expanded before the ring) and a
  seeded cotangent, ``"causal"``, ``"window"``, ``"rate"`` with
  ``"seed"``: the output and dq, dk, dv of the chunk.

Two kinds serve models on a (pipe 1, data 1, model T) mesh, each rank on
its ``shard_model`` shard (blocks split, embedding and head whole) of the
whole model: ``"tree"``'s weights, or ``init_params`` from a generator
on the rank's device seeded ``"init_seed"``. They need no schedule and
return their results in :func:`run_cases`' ``"cases"`` entry, not in a
file: each run's wall seconds (``"runs"`` runs, default 1; ``"t0"``,
the epoch second the first began), the kernel launches of the first and
the count and host ms of the last's model-axis all-reduces and
all-gathers (``Mesh.tp_stats``).

- ``"decode"``: ``make_pipeline_generate_fn`` over ``"n_stages"``
  lockstep stages with ``"N"`` new tokens and ``"decode"``'s keywords on
  ``"prompts"[case["prompt"]]``, a generator seeded ``"seed"`` for each
  run where it is given: the tokens (and log-probs).
- ``"serve"``: ``make_serving_step_fn`` with ``"program"``'s keywords and
  a ``ServingEngine`` over ``"requests"[case["requests"]]`` (``(rid,
  prompt, max_new_tokens, arrival)`` rows), continuous batching; with
  ``"draft_cfg"`` (and ``"draft_tree"`` or ``"draft_init_seed"``) the
  program is speculative and the draft whole on every rank: each
  completion's (rid, tokens, slot, first and finish tick, status), the
  ticks, the acceptance rate and ``program.cuda_graphs``; a paged
  program's pool passes ``check_invariants``.

Every rank runs every case in order, so the collectives pair.
"""

from __future__ import annotations

import copy
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


def _attn_case(mesh: Mesh, case: dict) -> Dict[str, np.ndarray]:
    """An ``"attn"`` case's chunk outputs (see the module doc)."""
    from ..ops.attention import gqa_expand
    from .ring_attention import ring_attention
    from .ulysses import ulysses_attention
    b, s, h, h_kv, dh = (case[k] for k in ("b", "s", "h", "h_kv", "dh"))
    g = np.random.default_rng(case.get("data_seed", 0))
    q, k, v, ct = (torch.from_numpy(g.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, dh), (b, s, h_kv, dh),
                                   (b, s, h_kv, dh), (b, s, h, dh)))
    c = s // mesh.n_seq
    lo = mesh.seq * c
    q, k, v = (x[:, lo:lo + c].clone().requires_grad_() for x in (q, k, v))
    if case["impl"] == "ring":
        kk, vv = gqa_expand(k, v, h)
        out = ring_attention(q, kk, vv, mesh, case["causal"],
                             case.get("rate", 0.0), case.get("seed"),
                             case.get("window"))
    else:
        out = ulysses_attention(q, k, v, mesh, case["causal"],
                                case.get("rate", 0.0), case.get("seed"),
                                case.get("window"))
    out.backward(ct[:, lo:lo + c])
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _fsdp_fit(mesh: Mesh, cfg, sched, view, case, shard, out: str):
    """An ``"fsdp_fit"`` case (see the module doc)."""
    from ..utils import train as ttrain
    from ..utils.checkpoint import restore_world_model
    from ..utils.data import synthetic_batches
    from ..utils.resilience import FaultPlan, SimulatedKill

    def run(model, steps, **kw):
        data = synthetic_batches(cfg.vocab_size, case["B"], case["S"],
                                 seed=1, sharding=shard)
        trained, _ = ttrain.fit(cfg, sched, mesh.n_pipe, copy.deepcopy(model),
                                data, steps,
                                optimizer=ttrain.sgd(0.1), log_every=1,
                                verbose=False, device=mesh.device, mesh=mesh,
                                **kw)
        return trained

    res = {}
    for label, kw in (("replicated", {}), ("fsdp", dict(fsdp=True))):
        res.update({f"{label}/{k}": v for k, v in _params(run(
            view, case["steps"], **kw)).items()})
    ck = os.path.join(out, f"{case['name']}_ck")
    try:
        run(view, case["steps"], fsdp=True, checkpoint_dir=ck,
            checkpoint_every=1,
            fault_plan=FaultPlan(kill_in_save_step=case["kill"]))
        raise RuntimeError("the planned kill did not come")
    except SimulatedKill:
        pass
    res.update({f"resumed/{k}": v for k, v in _params(run(
        view, case["steps"], fsdp=True, checkpoint_dir=ck,
        checkpoint_every=1, resume=True)).items()})
    mesh.barrier()
    if mesh.rank == 0:
        last = os.path.join(ck, f"step_{case['steps'] - 1}")
        res.update({f"whole/{k}": v.numpy() for k, v in
                    restore_world_model(last, cfg).items()})
    return res


def _moe_fit(mesh: Mesh, cfg, sched, view, case, moe, shard, out: str):
    """A ``"moe_fit"`` case (see the module doc)."""
    from ..utils import train as ttrain
    from ..utils.checkpoint import restore_world_model
    from ..utils.data import synthetic_batches
    from ..utils.resilience import FaultPlan, SimulatedKill
    from .fsdp import fsdp_shard_of

    fit_kw = case.get("fit_kw", {})
    base = (ttrain.adamw(**case["opt"]) if case.get("adamw")
            else ttrain.sgd(0.1))

    def run(steps, optimizer=base, **kw):
        data = synthetic_batches(cfg.vocab_size, case["B"], case["S"],
                                 seed=1, sharding=shard)
        trained, _ = ttrain.fit(cfg, sched, mesh.n_pipe, copy.deepcopy(view),
                                data, steps, optimizer=optimizer,
                                log_every=1, verbose=False,
                                device=mesh.device, mesh=mesh, moe=moe, **kw)
        return trained

    res = {f"plain/{k}": v for k, v in _params(run(case["steps"])).items()}
    if fit_kw:
        par = run(case["steps"], **fit_kw)
        res.update({f"par/{k}": v for k, v in _params(par).items()})
        if fsdp_shard_of(par) is not None:
            res.update({f"fsdp/{n}": np.asarray(d) for n, d in
                        fsdp_shard_of(par).dims.items() if d is not None})
    else:
        res.update({f"adamw/{k}": v for k, v in _params(run(
            2, ttrain.adamw(**case["opt"]))).items()})
    ck = os.path.join(out, f"{case['name']}_ck")
    try:
        run(case["steps"], checkpoint_dir=ck, checkpoint_every=1,
            fault_plan=FaultPlan(kill_in_save_step=case["kill"]), **fit_kw)
        raise RuntimeError("the planned kill did not come")
    except SimulatedKill:
        pass
    res.update({f"resumed/{k}": v for k, v in _params(run(
        case["steps"], checkpoint_dir=ck, checkpoint_every=1,
        resume=True, **fit_kw)).items()})
    mesh.barrier()
    if mesh.rank == 0:
        last = os.path.join(ck, f"step_{case['steps'] - 1}")
        res.update({f"whole/{k}": v.numpy() for k, v in
                    restore_world_model(last, cfg).items()})
    return res


def _launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters, by kernel name."""
    from ..ops.flash_attention import FLASH_BWD, FLASH_FWD
    from ..ops.fused_xent import XENT_BWD, XENT_FWD
    return {k.name: k.launches
            for k in (FLASH_FWD, XENT_FWD, FLASH_BWD, XENT_BWD)}


def _timed_runs(fn, case: dict, mesh: Mesh) -> tuple:
    """(the first run's value, its info): ``case["runs"]`` runs of
    ``fn`` with their wall seconds, the first's kernel launches and the
    last's model-axis collectives (count and host ms by kind)."""
    import time

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    info: Dict = {"wall_s": [], "t0": time.time()}
    first = None
    for i in range(case.get("runs", 1)):
        before, stats = _launch_counts(), copy.deepcopy(mesh.tp_stats)
        sync()
        t = time.perf_counter()
        value = fn()
        sync()
        info["wall_s"].append(time.perf_counter() - t)
        if i == 0:
            first = value
            info["launches"] = {k: n - before[k]
                                for k, n in _launch_counts().items()}
        info["collectives"] = {
            k: dict(count=n - stats.get(k, [0, 0.0])[0],
                    host_ms=(s - stats.get(k, [0, 0.0])[1]) * 1e3)
            for k, (n, s) in mesh.tp_stats.items()}
    return first, info


def _whole_model(cfg: ModelConfig, spec: dict, case: dict, device,
                 prefix: str = ""):
    """The whole model of a serving case: ``spec["trees"]`` at
    ``case[prefix + "tree"]``, or ``init_params`` seeded
    ``case[prefix + "init_seed"]``."""
    from ..models.transformer import init_params
    from ..utils.weights import from_jax_params
    if prefix + "init_seed" in case:
        gen = torch.Generator(device=device).manual_seed(
            case[prefix + "init_seed"])
        return init_params(cfg, gen, device)
    return from_jax_params(cfg, spec["trees"][case[prefix + "tree"]],
                           device=device)


def _decode_case(mesh: Mesh, spec: dict, case: dict) -> dict:
    from .pipelined_decode import make_pipeline_generate_fn
    from .tensor_parallel import shard_model
    device = mesh.device
    cfg = ModelConfig(**spec["cfgs"][case["cfg"]])
    model = shard_model(_whole_model(cfg, spec, case, device), cfg, mesh)
    prompt = torch.as_tensor(spec["prompts"][case["prompt"]], device=device)
    gen = make_pipeline_generate_fn(cfg, case["n_stages"], case["N"],
                                    mesh=mesh, device=device,
                                    **case.get("decode", {}))

    def run():
        extra = (() if "seed" not in case else
                 (torch.Generator(device=device).manual_seed(case["seed"]),))
        out = gen(model, prompt, *extra)
        return [x.cpu().numpy() for x in (out if isinstance(out, tuple)
                                          else (out,))]

    out, info = _timed_runs(run, case, mesh)
    info["outputs"] = out
    return info


def _serve_case(mesh: Mesh, spec: dict, case: dict) -> dict:
    from ..serving.engine import Request, ServingEngine, make_serving_step_fn
    from .tensor_parallel import shard_model
    device = mesh.device
    cfg = ModelConfig(**spec["cfgs"][case["cfg"]])
    model = shard_model(_whole_model(cfg, spec, case, device), cfg, mesh)
    kw, draft = dict(case["program"]), None
    if "draft_cfg" in case:
        dcfg = ModelConfig(**spec["cfgs"][case["draft_cfg"]])
        draft = _whole_model(dcfg, spec, case, device, "draft_")
        kw.update(speculative=True, draft_cfg=dcfg)
    program = make_serving_step_fn(cfg, case["n_stages"], mesh=mesh,
                                   device=device, **kw)
    engine = ServingEngine(program, model, draft_params=draft)
    requests = [Request(*r) for r in spec["requests"][case["requests"]]]
    res, info = _timed_runs(lambda: engine.run(requests), case, mesh)
    if engine.paging is not None:
        engine.paging.check_invariants()
    info.update(completions=[(c.rid, c.tokens, c.slot, c.first_token_tick,
                              c.finish_tick, c.status)
                             for c in res.completions],
                ticks=res.ticks, acceptance_rate=res.acceptance_rate,
                cuda_graphs=program.cuda_graphs)
    return info


def run_cases(world: Mesh, spec: dict) -> dict:
    """Run ``spec``'s cases on this rank (see the module doc); returns
    ``{"rank": r, "seconds": {case: s}, "cases": {case: info} (the
    serving kinds'), "modules": [top-level modules this process
    imported]}``."""
    import time

    from ..utils import train as ttrain
    from ..utils.data import batch_sharding, synthetic_batches
    from ..utils.resilience import FaultPlan
    from ..utils.telemetry import PipelineTelemetry
    from ..utils.weights import from_jax_params
    from .fsdp import (fsdp_shard_of, fsdp_shard_params, make_fsdp_grad_fn,
                       shard_params_fsdp)
    from ..models.moe import MoEConfig
    from .pipeline import (make_pipeline_forward, make_pipeline_grad_fn,
                           make_pipeline_loss_fn, owned_layers)
    from .tensor_parallel import TPShard, make_tp_grad_fn

    torch.set_num_threads(spec.get("threads", 1))
    device = world.device
    meshes = {}

    def mesh_of(case):
        shape = (case["n_pipe"], case["n_data"], case.get("n_model", 1),
                 case.get("n_seq", 1), case.get("n_expert", 1))
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, backend=world.backend,
                                      device=device)
        return meshes[shape]

    out, rank = spec.get("out"), world.rank
    seconds, infos = {}, {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        name, kind = case["name"], case["kind"]
        mesh = mesh_of(case)
        if kind in ("decode", "serve"):
            infos[name] = (_decode_case if kind == "decode"
                           else _serve_case)(mesh, spec, case)
            seconds[name] = time.perf_counter() - t0
            continue
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
        moe = MoEConfig(**case["moe"]) if "moe" in case else None
        expert = (mesh.n_expert, mesh.expert)
        view = from_jax_params(cfg, tree, device=device, layers=own,
                               shard=tp, moe=moe, expert=expert)
        fsdp = case.get("fsdp", False)
        impl = case.get("sp_attn_impl", "ring")
        if fsdp and kind != "fsdp_fit":
            view = fsdp_shard_params(view, cfg, mesh)
        if kind == "grad":
            tel = PipelineTelemetry() if case.get("telemetry") else None
            dyn = case.get("dynamics", False)
            fn = make_pipeline_grad_fn(cfg, sched, D, device=device,
                                       mesh=mesh,
                                       comm_overlap=case["comm_overlap"],
                                       tp_vocab_parallel=vp, telemetry=tel,
                                       dynamics=dyn, sp_attn_impl=impl,
                                       fsdp=fsdp, moe=moe)
            hops, a2a = mesh.hops, mesh.a2a
            loss = fn(view, *local, *seed)
            extra = {"hops": np.asarray(mesh.hops - hops),
                     "a2a": np.asarray(mesh.a2a - a2a)}
            if fsdp:
                extra.update({f"fsdp/{n}": np.asarray(d) for n, d in
                              fsdp_shard_of(view).dims.items()
                              if d is not None})
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
                                         mesh=mesh, sp_attn_impl=impl,
                                         fsdp=fsdp, moe=moe)(view, *local)
            extra = {}
            if rank == 0 and moe is None:
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
        elif kind == "fsdp_fit":
            np.savez(os.path.join(out, f"{name}_r{rank}.npz"),
                     **_fsdp_fit(mesh, cfg, sched, view, case, shard, out))
        elif kind == "fsdp_grad_fn":
            whole = shard_params_fsdp(
                from_jax_params(cfg, tree, device=device), mesh)
            loss = make_fsdp_grad_fn(cfg, mesh, device=device)(whole, *local)
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, whole,
                 extra={f"fsdp/{n}": np.asarray(d) for n, d in
                        fsdp_shard_of(whole).dims.items() if d is not None})
        elif kind == "sp_loss":
            from .seq_parallel import make_sp_loss_fn
            whole = from_jax_params(cfg, tree, device=device)
            loss = make_sp_loss_fn(cfg, mesh, impl)(whole, *local)
            loss.backward()
            mesh.all_reduce([p.grad for p in whole.parameters()], "seq")
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, whole)
        elif kind == "forward":
            logits = make_pipeline_forward(cfg, sched, D, device=device,
                                           mesh=mesh)(view, local[0])
            np.savez(os.path.join(out, f"{name}_r{rank}.npz"),
                     logits=logits.numpy())
        elif kind == "ep_loss":
            from .expert_parallel import ep_reduce_grads, make_ep_loss_fn
            loss = make_ep_loss_fn(cfg, moe, mesh)(view, *local)
            loss.backward()
            ep_reduce_grads(view, mesh)
            _npz(os.path.join(out, f"{name}_r{rank}.npz"), loss, view)
        elif kind == "moe_fit":
            whole_view = from_jax_params(cfg, tree, device=device,
                                         layers=own, moe=moe)
            np.savez(os.path.join(out, f"{name}_r{rank}.npz"),
                     **_moe_fit(mesh, cfg, sched, whole_view, case, moe,
                                shard, out))
        elif kind == "attn":
            np.savez(os.path.join(out, f"{name}_r{rank}.npz"),
                     **_attn_case(mesh, case))
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        seconds[name] = time.perf_counter() - t0
    return {"rank": rank, "seconds": seconds, "cases": infos,
            "modules": sorted({m.split(".")[0] for m in sys.modules})}
