"""PyTorch/CUDA port of the pipeline-parallel framework, for one NVIDIA
H100 (Hopper, sm_90a).

A package of its own beside ``distributed_training_with_pipeline_parallelism_tpu``
(the JAX reference, which it never imports). Module names mirror the JAX
package's. This slice ports the KV-cache decode path of GPT-2: the
single-device ``generate`` and the round-robin pipelined decoder over D
lockstep stages, with hand-written CUDA kernels for the flash-attention
forward of the prefill (``csrc/flash_fwd.cu``) and the fused
cross-entropy forward of the token log-probabilities (``csrc/xent_fwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

from .models.generate import generate
from .models.gpt2 import gpt2_config
from .models.transformer import init_params
from .parallel.pipelined_decode import make_pipeline_generate_fn
from .utils.config import ModelConfig
from .utils.weights import from_jax_params

__all__ = ["ModelConfig", "gpt2_config", "generate",
           "make_pipeline_generate_fn", "init_params", "from_jax_params"]
