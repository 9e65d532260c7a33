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
  the timed loop (``run_train_iterations``).

Hand-written CUDA kernels (``csrc/``): flash-attention forward and
backward (``flash_fwd.cu``, ``flash_bwd.cu``) and the fused cross-entropy
forward and backward (``xent_fwd.cu``, ``xent_bwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

from .models.generate import generate
from .models.gpt2 import gpt2_config
from .models.transformer import init_params
from .parallel.pipeline import make_pipeline_grad_fn
from .parallel.pipelined_decode import make_pipeline_generate_fn
from .parallel.schedules import compile_schedule
from .utils.config import ModelConfig, RunConfig, ScheduleConfig
from .utils.metrics import run_train_iterations
from .utils.train import adamw, make_train_step
from .utils.weights import from_jax_params

__all__ = ["ModelConfig", "ScheduleConfig", "RunConfig", "gpt2_config",
           "generate", "make_pipeline_generate_fn", "init_params",
           "from_jax_params", "compile_schedule", "make_pipeline_grad_fn",
           "make_train_step", "adamw", "run_train_iterations"]
