"""Train a model-ladder config under a pipeline schedule on one card (the
counterpart of ``scripts/train.py``: the same flags and defaults, through
``utils.train.fit``).

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 4 --schedule 1F1B --microbatches 4 \\
        --batch 24 --seq 1024 --steps 20 --ckpt /tmp/ck --eval-every 10 \\
        --flash on --fused-xent --dtype bfloat16 --param-dtype float32

    # zero-bubble: ZBH1, or ZBV with its two V-placed chunks a device
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 4 --schedule ZBH1 --microbatches 4 \\
        --batch 24 --seq 1024 --steps 20
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 2 --schedule ZBV --microbatches 4 \\
        --batch 24 --seq 1024 --steps 20

    # a tiny run on the CPU (the kernels' plain versions)
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model ref --layers 2 --dim 32 --heads 2 --vocab 64 --seq 16 \\
        --batch 4 --steps 2 --pipe 2 --device cpu

    # a world: one process per (data, pipe) coordinate, 2 x 2, ZeRO-1
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 2 --data 2 --backend gloo --zero1 \\
        --batch 24 --seq 1024 --steps 20 --flash on --fused-xent

    # a run report and a Perfetto trace of the last step's ticks
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 4 --batch 24 --seq 1024 --steps 20 \\
        --flash on --fused-xent --report-dir /tmp/run

    # Megatron tensor parallelism: pipe 2 x model 2, the head split over
    # the vocab (a tiny run on the CPU)
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --layers 4 --dim 32 --heads 2 --vocab 96 \\
        --seq 16 --batch 8 --steps 4 --pipe 2 --tp 2 --vocab-parallel \\
        --backend gloo --device cpu

    # FSDP (ZeRO-3) on the data axis, and sequence parallelism (Ulysses)
    # on a seq axis: pipe 2 x data 2, pipe 2 x seq 2
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 2 --data 2 --fsdp --backend gloo \\
        --batch 8 --seq 1024 --steps 20 --flash on --fused-xent
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --pipe 2 --sp 2 --sp-attn ulysses \\
        --backend gloo --batch 8 --seq 1024 --steps 20 --fused-xent

    # Mixture-of-Experts blocks (8 experts, top-2), lockstep; then their
    # experts split over an expert axis of 2: pipe 2 x expert 2
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --pipe 2 --batch 8 --seq 1024 \\
        --steps 20 --fused-xent
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --ep 2 --pipe 2 --backend gloo \\
        --batch 8 --seq 1024 --steps 20 --fused-xent

    # MoE composed with the other axes (8 processes each): each expert's
    # ffn split over a model axis; the experts' matrices FSDP-sharded over
    # a data axis; a seq axis (Ulysses); ZeRO-1 over data beside experts
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --ep 2 --tp 2 --pipe 2 \\
        --backend gloo --batch 8 --seq 1024 --steps 20 --fused-xent
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --ep 2 --fsdp --data 2 --pipe 2 \\
        --backend gloo --batch 8 --seq 1024 --steps 20 --fused-xent
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --ep 2 --sp 2 --sp-attn ulysses \\
        --pipe 2 --backend gloo --batch 8 --seq 1024 --steps 20 --fused-xent
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.train \\
        --model gpt2-small --moe-experts 8 --ep 2 --zero1 --data 2 --pipe 2 \\
        --backend gloo --batch 8 --seq 1024 --steps 20 --fused-xent

Without ``--backend`` all D = ``--pipe`` stages run in one process on the
one device, in lockstep over the schedule's tick table. ``--backend gloo``
or ``nccl`` launches a world of ``--pipe`` x ``--data`` x ``--tp`` x
``--sp`` processes (``parallel.mesh.launch``): each runs its pipe
coordinate's row of the table on its view of the model (with ``--tp``
above 1, its model coordinate's Megatron shard of it; with ``--fsdp``,
its data coordinate's shards of the blocks' matrices) and its data
replica's rows of each global batch (with ``--sp`` above 1, its seq
coordinate's chunk of each sequence, attention by ``--sp-attn``; on
CUDA, gloo stages every hand-off and collective through host memory;
nccl needs a card per process). ``--data``, ``--tp``, ``--sp`` or
``--ep`` above 1 needs a backend; ``--vocab-parallel`` needs ``--tp``
above 1; ``--fsdp`` needs ``--data`` above 1 and refuses ``--zero1``.
``--moe-experts N`` (with ``--moe-topk``, ``--moe-capacity``,
``--moe-aux``) builds a ``models.moe.MoEConfig`` and trains a MoE LM of
GPT-2 blocks (a ``gpt2-*`` model); ``--ep`` above 1 splits its experts
over an expert axis of that size (which also splits the batch, with the
data axis), and needs ``--moe-experts``. MoE composes with ``--tp``,
``--sp``, ``--fsdp`` and ``--zero1`` as the dense blocks do.
``--report-dir`` stamps every step's ticks (``utils.telemetry.
PipelineTelemetry``) and writes ``events.jsonl``, ``report.json`` (the
``RunReport`` manifest of ``fit``) and ``trace.json`` (the newest step's
ticks as a Perfetto trace: open it in ui.perfetto.dev) there; in a world
global rank 0 writes them, from every rank's stamps. ``--dynamics`` adds
the per-stage gradient statistics, the gradient-noise scale and the
loss-spike forensics (``utils.dynamics``, read at the log points with the
loss; the bundles need ``--report-dir``); with ``--prefetch`` the batch
digests are taken from the host arrays before their copy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .parallel.schedules import schedule_names


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-small",
                    help="gpt2-{small,medium,large,xl}, a llama_config name "
                         "(llama2-7b, llama3.2-1b, mistral-7b-v0.1, "
                         "qwen2-0.5b, gemma-2b, llama-debug, ...), or ref "
                         "(the reference's ref_decoder)")
    ap.add_argument("--schedule", default="1F1B",
                    choices=list(schedule_names()),
                    help="a built-in schedule or one registered with "
                         "parallel.schedules.register_schedule")
    ap.add_argument("--pipe", type=int, default=2)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel (model-axis) size: Megatron "
                         "shards of each stage, one process each (needs "
                         "--backend)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel (seq-axis) size: each process "
                         "holds a chunk of every sequence (needs "
                         "--backend)")
    ap.add_argument("--sp-attn", default="ring", choices=["ring", "ulysses"],
                    help="attention over the seq axis: the K/V ring or the "
                         "head all-to-all")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard the blocks' matrices over the "
                         "--data axis, gathered just in time")
    ap.add_argument("--vocab-parallel", action="store_true",
                    help="split the head and its cross entropy over the "
                         "vocab across the --tp model axis")
    ap.add_argument("--backward", default="auto",
                    choices=["auto", "remat", "stored"],
                    help="pipeline backward: auto (plain autograd at --pipe "
                         "1, the rematerialising backward above), remat, "
                         "stored (not for the split-backward ZBH1/ZBV)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="virtual stages per device (default: 2 for ZBV, "
                         "else 1)")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="accumulate gradients over k batches per optimizer "
                         "update (on top of per-step microbatching)")
    ap.add_argument("--param-dtype", default="",
                    help="master-weight dtype; 'float32' with --dtype "
                         "bfloat16 is the mixed-precision recipe")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--max-grad-norm", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="train-mode dropout rate; masks are seeded from "
                         "--seed and independent of the stage split")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--flash", default=None, nargs="?", const="on",
                    choices=["on", "off", "auto"],
                    help="the hand-written flash-attention kernels (bare "
                         "--flash means on; default auto: the kernel for "
                         "causal attention on the card)")
    ap.add_argument("--fused-xent", action="store_true",
                    help="the hand-written fused cross-entropy kernels")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir: step-numbered saves + final")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every N steps (default: final only)")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from the newest committed checkpoint in "
                         "--ckpt")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="retention: keep only the newest K committed "
                         "checkpoints in --ckpt (0 keeps everything)")
    ap.add_argument("--anomaly-guard", action="store_true",
                    help="check loss and gradients for non-finite values on "
                         "the card each step and skip a bad step")
    ap.add_argument("--anomaly-budget", type=int, default=3,
                    help="abort (after a final checkpoint) once this many "
                         "CONSECUTIVE steps are non-finite")
    ap.add_argument("--preemption-safe", action="store_true",
                    help="catch SIGTERM/SIGINT, finish the in-flight step, "
                         "write a sync checkpoint to --ckpt, exit resumable")
    ap.add_argument("--stall-timeout", type=float, default=0.0,
                    help="log a stall when no step completes for this many "
                         "seconds (0 disables)")
    ap.add_argument("--dynamics", action="store_true",
                    help="per-stage gradient statistics, the gradient-noise "
                         "scale and loss-spike forensics (bundles need "
                         "--report-dir), read at the log points")
    ap.add_argument("--report-dir", default="",
                    help="write the run report (events.jsonl, report.json) "
                         "and a Perfetto trace of the last step's ticks "
                         "(trace.json) into this dir")
    ap.add_argument("--metrics", default="",
                    help="append per-log-point JSON lines here")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler Chrome trace of 3 "
                         "steady-state steps into this dir")
    ap.add_argument("--resume", default="",
                    help="load the model's weights from a checkpoint of "
                         "this package (a --ckpt dir, its newest committed "
                         "step, or one step_N dir); the JAX package's Orbax "
                         "checkpoints need JAX and are not read")
    ap.add_argument("--dim", type=int, default=0,
                    help="override model width; ffn_dim rescales "
                         "proportionally unless --ffn is also given")
    ap.add_argument("--ffn", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--tie-embeddings", action="store_true")
    ap.add_argument("--pad-id", type=int, default=-1,
                    help="ignore-index target id (-1 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-file", default="",
                    help="flat binary token file (uint16 ids); default is "
                         "the reference's synthetic random-token regime")
    ap.add_argument("--eval-file", default="",
                    help="held-out token file for --eval-every")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate every N steps (and at the end)")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--native-loader", action="store_true",
                    help="read --data-file through the C++ loader "
                         "(csrc/data_loader.cpp, built at first use)")
    ap.add_argument("--loader-threads", type=int, default=1,
                    help="native-loader threads; 1 keeps the batch stream "
                         "deterministic in --seed, which --auto-resume's "
                         "data replay depends on")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="device-prefetch depth (0 disables)")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="Mixture-of-Experts: number of experts (MoE "
                         "blocks replace dense FFNs)")
    ap.add_argument("--moe-topk", type=int, default=2)
    ap.add_argument("--moe-capacity", type=float, default=1.25,
                    help="capacity factor (slots per expert scale)")
    ap.add_argument("--moe-aux", type=float, default=0.01,
                    help="load-balancing aux loss weight")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel (expert-axis) size; requires "
                         "--moe-experts divisible by it (needs --backend)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="run one process per (data, pipe) coordinate over "
                         "torch.distributed with this backend (default: "
                         "every stage in this process, in lockstep)")
    return ap


def check_ported(args) -> None:
    """The JAX script's refusal of an expert axis without MoE."""
    if args.ep > 1 and not args.moe_experts:
        raise ValueError("--ep requires --moe-experts: mesh has an "
                         "'expert' axis but no MoEConfig given")


def build_config(args):
    """The model config of ``--model`` with the width, depth and routing
    overrides (the family's FFN ratio kept under ``--dim``)."""
    from .models.gpt2 import gpt2_config
    from .models.llama import llama_config
    from .utils.config import ModelConfig

    def build(**overrides):
        if args.model.startswith("gpt2-"):
            return gpt2_config(args.model.removeprefix("gpt2-"), **overrides)
        if args.model.startswith(("llama", "mistral", "qwen2", "gemma")):
            return llama_config(args.model, **overrides)
        if args.model == "ref":
            return ModelConfig(**overrides)
        raise SystemExit(f"unknown model {args.model}")

    overrides = {k: v for k, v in dict(
        dim=args.dim, ffn_dim=args.ffn, n_layers=args.layers,
        n_heads=args.heads, vocab_size=args.vocab).items() if v}
    overrides["dtype"] = args.dtype
    if args.pad_id >= 0:
        overrides["pad_token_id"] = args.pad_id
    if args.tie_embeddings:
        overrides["tie_embeddings"] = True
    if args.param_dtype:
        overrides["param_dtype"] = args.param_dtype
    if args.dropout:
        overrides["dropout"] = args.dropout
    if args.flash is not None:
        overrides["use_flash_attention"] = {
            "on": True, "off": False, "auto": "auto"}[args.flash]
    if args.fused_xent:
        overrides["use_fused_xent"] = True
    if args.dim and not args.ffn:
        base = build()
        overrides["ffn_dim"] = max(1, round(base.ffn_dim * args.dim / base.dim))
    return build(**overrides)


def _load_weights(model, path: str, mesh=None) -> str:
    """Copy the model weights of a checkpoint of this package into
    ``model`` (a rank's view, or its Megatron shard, takes its own
    entries: from its coordinates' file of a world's checkpoint, or cut
    from the whole model; the lockstep process takes a world's files
    merged, ``utils.checkpoint.restore_world_model``); the step dir
    read."""
    from .parallel.tensor_parallel import model_shard_of, shard_state
    from .utils.checkpoint import restore_checkpoint, restore_world_model
    from .utils.resilience import world_state_file
    from .utils.train import _latest_step_dir
    latest = _latest_step_dir(path)
    if latest is not None:
        path = latest[1]
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        raise SystemExit(f"--resume {path}: not a checkpoint of this package "
                         f"(a --ckpt dir or one of its step_N dirs)")
    from .parallel.fsdp import fsdp_shard_of
    from .parallel.tensor_parallel import shard_tensor
    fsdp = fsdp_shard_of(model)
    own = [] if mesh is None else [
        n for n in (world_state_file(mesh), world_state_file(mesh, True))
        if os.path.exists(os.path.join(path, n))]
    saved = None
    for name in own:  # this rank's own file, if it holds this layout
        state = restore_checkpoint(path, name)
        if bool(state.get("fsdp")) == (fsdp is not None):
            saved = state["model"]
            break
    if saved is None:
        saved = restore_world_model(path, model.cfg)
        shard = model_shard_of(model)
        if shard is not None:
            saved = shard_state(saved, model.cfg, shard)
        if fsdp is not None:
            saved = {k: shard_tensor(v, fsdp.dims.get(k), fsdp.n,
                                     fsdp.index) for k, v in saved.items()}
    expert = getattr(model, "expert", (1, 0))
    if expert[0] > 1:  # a checkpoint holds the whole expert stacks
        from .parallel.expert_parallel import ep_shard_state
        saved = ep_shard_state(saved, expert)
    model.load_state_dict({k: saved[k] for k in model.state_dict()})
    return path


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.native_loader and not args.data_file:
        ap.error("--native-loader requires --data-file")
    for flag, given in (("--auto-resume", args.auto_resume),
                        ("--keep-last", args.keep_last),
                        ("--preemption-safe", args.preemption_safe)):
        if given and not args.ckpt:
            ap.error(f"{flag} requires --ckpt")
    check_ported(args)
    for flag, n in (("--data", args.data), ("--tp", args.tp),
                    ("--sp", args.sp), ("--ep", args.ep)):
        if n > 1 and args.backend is None:
            ap.error(f"{flag} > 1 runs one process per (data, pipe, model, "
                     f"seq, expert) coordinate: pass --backend gloo or nccl")
    if args.vocab_parallel and args.tp <= 1:
        ap.error("--vocab-parallel requires --tp > 1")
    if args.moe_experts and not args.model.startswith("gpt2-"):
        ap.error("--moe-experts uses gpt2-style blocks; pick a gpt2-* model")
    if args.backend is None:
        return run(args)
    from .parallel.mesh import launch
    from .utils.config import MeshConfig
    launch(_rank_main, MeshConfig(args.pipe, args.data, args.tp, args.sp,
                                  args.ep),
           args, backend=args.backend, device=args.device)
    return 0


def _rank_main(mesh, args) -> int:
    """One rank of a ``--backend`` world."""
    return run(args, mesh)


def run(args, mesh=None) -> int:
    """Train as ``args`` say: every stage in this process, or this rank's
    part of a world (``mesh``)."""
    import torch

    from .models.transformer import init_params
    from .parallel.pipeline import owned_layers
    from .utils import train
    from .utils.config import ScheduleConfig, resolve_device
    from .utils.data import (TokenFileDataset, batch_sharding,
                             prefetch_to_device, token_file_dtype)
    from .utils.resilience import AnomalyGuard
    from .utils.telemetry import PipelineTelemetry, write_perfetto_trace

    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = build_config(args)
    sched = ScheduleConfig(name=args.schedule,
                           n_microbatches=args.microbatches,
                           n_virtual=args.virtual or (
                               2 if args.schedule == "ZBV" else 1))
    moe = None
    if args.moe_experts:
        from .models.moe import MoEConfig
        moe = MoEConfig(n_experts=args.moe_experts, top_k=args.moe_topk,
                        capacity_factor=args.moe_capacity,
                        aux_loss_weight=args.moe_aux)
    moe_desc = f" MoE E={args.moe_experts}" if moe else ""
    say(f"model={args.model}{moe_desc} {cfg.dim}d x {cfg.n_layers}L x "
        f"{cfg.n_heads}H, mesh=(data={args.data}, pipe={args.pipe}, "
        f"model={args.tp}, seq={args.sp}, expert={args.ep}) on {device}, "
        f"{args.schedule} M={args.microbatches} V={sched.n_virtual}"
        + (", fsdp" if args.fsdp else "")
        + (f", sp-attn {args.sp_attn}" if args.sp > 1 else ""), flush=True)
    if mesh is not None:
        say(f"world: {args.data} data x {args.pipe} pipe x {args.tp} model "
            f"x {args.sp} seq x {args.ep} expert ranks, {mesh.describe()}",
            flush=True)
    optimizer = train.adamw(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, max_grad_norm=args.max_grad_norm,
        total_steps=max(1, args.steps // args.grad_accum))
    layers = (None if mesh is None else
              owned_layers(cfg.n_layers, sched, args.pipe, mesh.pipe))
    gen = torch.Generator().manual_seed(args.seed)
    if moe is not None:
        from .models.moe import moe_init_params
        model = moe_init_params(cfg, moe, gen, device=device, layers=layers,
                                expert=(1, 0) if mesh is None
                                else (mesh.n_expert, mesh.expert))
    else:
        model = init_params(cfg, gen, device=device, layers=layers)
    if mesh is not None and mesh.n_model > 1:
        from .parallel.tensor_parallel import shard_model
        model = shard_model(model, cfg, mesh,
                            vocab_parallel=args.vocab_parallel)
    if args.fsdp and mesh is not None and mesh.n_data > 1:
        from .parallel.fsdp import fsdp_shard_params
        model = fsdp_shard_params(model, cfg, mesh)
    if args.resume:
        say(f"loaded weights from {_load_weights(model, args.resume, mesh)}",
            flush=True)
    # each rank keeps its data replica's rows of every global batch
    sharding = None if mesh is None else batch_sharding(mesh)

    if (args.data_file and args.native_loader
            and token_file_dtype(args.data_file) != np.uint16):
        raise SystemExit("--native-loader reads uint16 token files; this "
                         "corpus's .meta.json sidecar says otherwise — "
                         "drop --native-loader for it")
    loader = None
    if args.data_file and args.native_loader:
        from .utils.data_native import NativeTokenLoader
        loader = NativeTokenLoader(args.data_file, args.seq, args.batch,
                                   seed=args.seed,
                                   n_threads=args.loader_threads)
        data = loader.batches(sharding)
    elif args.data_file:
        data = TokenFileDataset(args.data_file, args.seq,
                                seed=args.seed).batches(args.batch, sharding)
    else:
        from .utils.data import synthetic_batches
        data = synthetic_batches(cfg.vocab_size, args.batch, args.seq,
                                 seed=args.seed, sharding=sharding)
    if args.prefetch > 0:
        data = prefetch_to_device(data, depth=args.prefetch, device=device,
                                  digest=args.dynamics)

    eval_data = None
    if args.eval_every:
        # --eval-file, else the training file (a fixed-batch probe, not
        # held out); synthetic only when training is synthetic too
        eval_src = args.eval_file or args.data_file
        if eval_src:
            eval_data = lambda: TokenFileDataset(  # noqa: E731
                eval_src, args.seq, seed=123).batches(args.batch, sharding)
        else:
            from .utils.data import synthetic_batches
            eval_data = lambda: synthetic_batches(  # noqa: E731
                cfg.vocab_size, args.batch, args.seq, seed=123,
                sharding=sharding)

    telemetry = PipelineTelemetry() if args.report_dir else None
    try:
        _, history = train.fit(
            cfg, sched, args.pipe, model, data, args.steps,
            optimizer=optimizer, log_every=max(1, args.steps // 20),
            checkpoint_dir=args.ckpt or None,
            checkpoint_every=(args.ckpt_every or args.steps) if args.ckpt
            else 0,
            resume=args.auto_resume, metrics_path=args.metrics or None,
            remat_backward={"auto": None, "remat": True,
                            "stored": False}[args.backward],
            dropout_seed=args.seed, eval_data=eval_data,
            eval_every=args.eval_every, eval_batches=args.eval_batches,
            profile_dir=args.profile or None, grad_accum=args.grad_accum,
            keep_last=args.keep_last or None,
            guard=(AnomalyGuard(max_consecutive=args.anomaly_budget)
                   if args.anomaly_guard else None),
            handle_preemption=args.preemption_safe,
            stall_timeout_s=args.stall_timeout or None, device=device,
            zero1=args.zero1, fsdp=args.fsdp, sp_attn_impl=args.sp_attn,
            mesh=mesh, tp_vocab_parallel=args.vocab_parallel,
            report_dir=args.report_dir or None, telemetry=telemetry,
            dynamics=args.dynamics or None, moe=moe)
    finally:
        if loader is not None:
            loader.close()
    if telemetry is not None and lead and telemetry.events:
        trace = write_perfetto_trace(
            telemetry, os.path.join(args.report_dir, "trace.json"))
        say(f"run report in {args.report_dir}, Perfetto trace {trace}",
            flush=True)
    if args.ckpt:
        say(f"checkpoints in {args.ckpt}", flush=True)
    if history:
        say(f"final loss: {history[-1][1]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
