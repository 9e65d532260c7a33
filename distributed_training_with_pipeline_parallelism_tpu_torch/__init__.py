"""PyTorch/CUDA port of the pipeline-parallel framework, for one NVIDIA
H100 (Hopper, sm_90a).

A package of its own beside ``distributed_training_with_pipeline_parallelism_tpu``
(the JAX reference, which it never imports). Module names mirror the JAX
package's. Ported so far:

- the KV-cache decode path of GPT-2: the single-device ``generate`` and
  the round-robin pipelined decoder over D lockstep stages;
- pipeline training of GPT-2: the ``[T, D, 17]`` tick tables of GPipe,
  1F1B, Interleaved-1F1B and BFS (``compile_schedule``), the tick executor
  with the rematerialising and stored backwards
  (``make_pipeline_grad_fn``), AdamW (``adamw``, ``make_train_step``) and
  the timed loop (``run_train_iterations``);
- the llama block family (``llama_config``: Llama-2/3/3.1/3.2, Mistral,
  Qwen2, Gemma) through all of the above;
- continuous-batching serving (``serving``: ``make_serving_step_fn``,
  ``ServingEngine``, the continuous-vs-static bench, load ramps, SLOs):
  the dense path, paged KV with a radix prefix cache (``paged=True``)
  and speculative draft-verify decoding (``speculative=True``);
- the reference's own model (``arch="ref_decoder"``, the ``ModelConfig``
  default) with train-mode dropout through every schedule, and its
  54-config experiment (``utils.sweep``: ``sweep_rows``,
  ``run_all_experiments``; ``python -m
  distributed_training_with_pipeline_parallelism_tpu_torch.run_sweep``)
  with the bubble, cost-model and memory-model columns (``analysis``);
- training jobs: ``fit`` (``python -m
  distributed_training_with_pipeline_parallelism_tpu_torch.train``) with
  the forward-only pipelined eval (``make_pipeline_loss_fn``), committed
  checkpoints with async saves and bit-exact resume, the anomaly guard,
  preemption and the fault plan (``utils.resilience``), gradient
  accumulation, and the token-file, native C++ and prefetching loaders
  (``utils.data``, ``utils.data_native``);
- zero-bubble training: ZBH1 and ZBV with the split backward (W units)
  and the V placement through the executor, ``fit``, the sweep and the
  cost and memory models, and the custom-schedule registry
  (``parallel.schedules.register_schedule``);
- the ``torch.distributed`` transport: one process per (data, pipe)
  coordinate (``MeshConfig``, ``launch``, ``make_mesh``), each running its
  row of the tick table on its view of the model (``owned_layers``) with
  the hand-offs as sends and receives, ``comm_overlap="ring"``, the
  data-parallel all-reduce and ZeRO-1 (``init_sharded_opt_state``),
  through ``make_train_step``, ``fit`` and ``train.py --backend``;
- FSDP (ZeRO-3) on the world's data axis (``parallel.fsdp``:
  ``fsdp_shard_params``, ``make_fsdp_grad_fn``; the blocks' matrices
  gathered just in time and their gradients reduce-scattered per unit)
  and sequence parallelism on a seq axis (``MeshConfig(n_seq=)``;
  ``parallel.ring_attention``, ``parallel.ulysses``,
  ``parallel.seq_parallel``), both inside the pipeline, through ``fit``
  and ``train.py --fsdp`` / ``--sp N --sp-attn {ring,ulysses}``; the
  world's axes are data x pipe x model x seq x expert, as the JAX mesh's;
- Mixture-of-Experts (``MoEConfig``, ``MoELM``, ``moe_lm_loss``;
  ``models.moe``): top-k capacity routing with the Switch aux loss, MoE
  blocks through the tick executor under every schedule, the eval (cross
  entropy only), ``fit`` and ``train.py --moe-experts``, lockstep or over
  an expert axis of the world (``MeshConfig(n_expert=)``,
  ``parallel.expert_parallel``: ``make_ep_loss_fn``; the slots exchanged
  by an all-to-all over the expert group, which also splits the batch)
  composed with the pipe and data axes (``train.py --ep N``);
- pipelined batch inference (``make_pipeline_forward``): the merged
  logits of the eval executor's fill-drain forward, lockstep or on data
  x pipe x model worlds;
- Megatron tensor parallelism on the world's model axis
  (``MeshConfig(n_model=T)``, ``parallel.tensor_parallel``:
  ``shard_model``, ``gather_model``, ``make_tp_grad_fn``;
  ``ops.collectives``: the conjugate collectives, the vocab-parallel
  cross entropy and the collective-matmul ring) inside the pipeline,
  through ``fit`` and ``train.py --tp``, and the reference's sweep run as
  a world of D processes (``run_one_experiment(backend=)``);
- TP in the pipelined decoder and the serving engine (contiguous, paged,
  speculative): ``make_pipeline_generate_fn(..., mesh=)`` and
  ``make_serving_step_fn(..., mesh=)`` on a (pipe 1, data 1, model T)
  world, each rank on its ``shard_model`` shard of the lockstep stages,
  its caches holding ``n_kv / T`` heads, the greedy heads vocab-parallel
  (``check_tp`` holds the shapes to the Megatron contract);
- run reports and pipeline telemetry, the static table verifier,
  certified schedule search and training dynamics;
- the model sources (``models.hf``): Hugging Face GPT-2, Llama, Mistral,
  Qwen2 and Gemma checkpoints in (``from_hf``) and out (``to_hf``,
  ``python -m distributed_training_with_pipeline_parallelism_tpu_torch.export_hf``),
  and the HF tokenizer route (``utils.data.encode_text_file_hf``);
- the cost model's calibration (``analysis.calibration``: measured probes,
  the ledger, fitted per-hardware corrections that ``fit`` and the sweep
  apply; ``python -m
  distributed_training_with_pipeline_parallelism_tpu_torch.probe``), the
  serving cost and memory models with the paged and speculative serving
  benches (``serving.run_paged_bench``, ``serving.run_spec_bench``), and
  the analysis passes (``python -m
  distributed_training_with_pipeline_parallelism_tpu_torch.analysis``).

Hand-written CUDA kernels (``csrc/``): flash-attention forward and
backward (``flash_fwd.cu``, ``flash_bwd.cu``) and the fused cross-entropy
forward and backward (``xent_fwd.cu``, ``xent_bwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

from .models.generate import generate
from .models.gpt2 import gpt2_config
from .models.llama import llama_config
from .models.transformer import init_params
from .parallel.fsdp import (fsdp_shard_params, make_fsdp_grad_fn,
                            shard_params_fsdp)
from .parallel.mesh import init_multihost, launch, make_mesh
from .models.moe import MoEConfig, MoELM, moe_lm_loss
from .parallel.expert_parallel import make_ep_loss_fn
from .parallel.pipeline import (make_pipeline_forward, make_pipeline_grad_fn,
                                make_pipeline_loss_fn, owned_layers)
from .parallel.pipelined_decode import make_pipeline_generate_fn
from .parallel.schedules import compile_schedule
from .parallel.tensor_parallel import check_tp, gather_model, shard_model
from .serving import (Request, ServingEngine, make_serving_step_fn,
                      run_serve_bench, synth_trace)
from .utils.config import MeshConfig, ModelConfig, RunConfig, ScheduleConfig
from .utils.metrics import run_train_iterations
from .utils.sweep import run_one_experiment, sweep_rows
from .parallel.seq_parallel import make_sp_loss_fn
from .utils.train import (adamw, fit, init_sharded_opt_state, make_train_step,
                          sgd)
from .utils.weights import from_jax_params

__all__ = ["ModelConfig", "ScheduleConfig", "RunConfig", "MeshConfig",
           "make_mesh", "launch", "init_multihost", "owned_layers",
           "init_sharded_opt_state", "shard_model", "gather_model",
           "check_tp",
           "fsdp_shard_params", "shard_params_fsdp", "make_fsdp_grad_fn",
           "make_sp_loss_fn", "sgd", "MoEConfig", "MoELM", "moe_lm_loss",
           "make_ep_loss_fn", "make_pipeline_forward",
           "gpt2_config",
           "llama_config", "generate", "make_pipeline_generate_fn",
           "init_params", "from_jax_params", "compile_schedule",
           "make_pipeline_grad_fn", "make_pipeline_loss_fn",
           "make_train_step", "adamw", "fit",
           "run_train_iterations", "run_one_experiment", "sweep_rows",
           "Request", "ServingEngine",
           "make_serving_step_fn", "run_serve_bench", "synth_trace"]
