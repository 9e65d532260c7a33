"""Model configuration for the PyTorch port.

The port's own copy of the fields of
``distributed_training_with_pipeline_parallelism_tpu/utils/config.py:ModelConfig``
that the port reads, under the same names, with the same
defaults and the same validation, plus ``ScheduleConfig``,
``virtual_stages_for``, ``MeshConfig`` and ``RunConfig``. The one
behavioural difference is :meth:`ModelConfig.flash_for`: the JAX package's ``"auto"`` cut-over
(causal, seq >= 1024, TPU only) is a TPU measurement and does not carry
over; here ``"auto"`` picks the hand-written kernel for every causal call
on a CUDA tensor and the plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..parallel.schedules import check_schedule_name


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer LM hyperparameters (see the module doc).

    ``arch`` selects one of the JAX package's three block families:
    ``"ref_decoder"`` (the reference's ``nn.TransformerDecoderLayer``
    called as ``layer(h, h)``: post-LN self- and cross-attention over the
    block's own input, relu FFN, no mask and no positions), ``"gpt2"``
    (pre-LN, causal, learned positions) and ``"llama"`` (pre-RMSNorm,
    RoPE, grouped-query attention, gated MLP).

    ``dropout`` is the train-mode rate at the JAX sites; it acts only
    where a step seed is passed (``make_pipeline_grad_fn``'s
    ``step_seed``, ``transformer_loss``'s ``rng``).
    """

    dim: int = 768
    n_layers: int = 8
    n_heads: int = 8
    vocab_size: int = 10000
    ffn_dim: int = 2048
    max_seq_len: int = 2048
    arch: str = "ref_decoder"
    dropout: float = 0.0
    dtype: str = "float32"
    # storage dtype of the parameters; None = same as ``dtype``
    param_dtype: Optional[str] = None
    # True: hand-written flash kernel; False: dense attention; "auto":
    # the kernel for causal attention on a CUDA tensor (see flash_for)
    use_flash_attention: Union[bool, str] = "auto"
    # route the loss and token log-probabilities through the fused-xent
    # kernels
    use_fused_xent: bool = False
    # tie the output head to the token embedding: no "out" matrix; logits
    # are norm(h) @ tok.T and tok takes gradient from both uses
    tie_embeddings: bool = False
    # ignore-index loss masking: targets equal to this id contribute
    # nothing, and the mean divides by the global valid-token count
    pad_token_id: Optional[int] = None
    # llama-only knobs: grouped-query kv heads (None = n_heads), the RoPE
    # base, Llama-3.1 rope scaling (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings) or None, the
    # RMSNorm epsilon, Mistral's sliding window (None = full causal) and
    # Qwen2's q/k/v biases
    n_kv_heads: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None
    attention_qkv_bias: bool = False
    # Gemma knobs (llama arch): a head width decoupled from dim/n_heads,
    # the gated MLP's gate ("silu" SwiGLU or "gelu" GeGLU, tanh
    # approximation), and embedding outputs scaled by sqrt(dim) (also
    # allowed on gpt2, where the scale precedes the positions)
    head_dim_override: Optional[int] = None
    mlp_act: str = "silu"
    embed_scale: bool = False
    # the MLP's tensor-parallel boundary (the JAX ``tp_overlap``): "none"
    # (copy in, all-reduce out), "ring" (the collective-matmul ring over
    # the model group), "auto" (resolves to "none": no cut-over measured
    # on the H100; parallel.tensor_parallel.resolve_tp_overlap)
    tp_overlap: str = "none"

    def __post_init__(self):
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} must be divisible by n_heads={self.n_heads}")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"n_heads={self.n_heads} must be divisible by n_kv_heads={self.n_kv_heads}")
        if self.arch not in ("ref_decoder", "gpt2", "llama"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.attention_qkv_bias and self.arch != "llama":
            raise ValueError("attention_qkv_bias requires arch='llama' "
                             "(Qwen2-family blocks; gpt2/ref biases are "
                             "always on)")
        if self.mlp_act not in ("silu", "gelu"):
            raise ValueError(f"mlp_act={self.mlp_act!r} must be 'silu' or "
                             f"'gelu'")
        if ((self.head_dim_override is not None or self.mlp_act != "silu")
                and self.arch != "llama"):
            raise ValueError("head_dim_override / mlp_act are Gemma-family "
                             "knobs on arch='llama' blocks")
        if self.embed_scale and self.arch == "ref_decoder":
            raise ValueError("embed_scale applies to gpt2/llama blocks "
                             "(Gemma-style scaled embeddings; gpt2 is "
                             "allowed so the MoE LM — gpt2-style blocks — "
                             "can use it)")
        if self.head_dim_override is not None and self.head_dim_override < 1:
            raise ValueError(f"head_dim_override={self.head_dim_override}")
        if self.sliding_window is not None:
            if self.arch != "llama":
                raise ValueError("sliding_window requires arch='llama' "
                                 "(Mistral-family blocks)")
            if self.sliding_window < 1:
                raise ValueError(f"sliding_window={self.sliding_window} must "
                                 f"be >= 1")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must be in [0, 1)")
        if self.use_flash_attention not in (True, False, "auto"):
            raise ValueError(
                f"use_flash_attention={self.use_flash_attention!r} must be "
                f"True, False, or 'auto'")
        if self.tp_overlap not in ("none", "ring", "auto"):
            raise ValueError(f"tp_overlap={self.tp_overlap!r} must be "
                             f"'none', 'ring' or 'auto'")
        if self.dropout > 0.0 and self.use_flash_attention is True:
            raise ValueError(
                "dropout composes with the dense attention path only: the "
                "flash kernel does not implement attention-prob dropout")

    def flash_for(self, causal: bool, device: torch.device) -> bool:
        """Resolve ``use_flash_attention`` for one attention call site.
        'auto' = the kernel for causal attention without dropout on a CUDA
        device, the plain dense path on the CPU. No cut-over length yet:
        one comes back once an H100 run decides it."""
        if self.use_flash_attention is True:
            return True
        if self.use_flash_attention == "auto":
            return (self.dropout == 0.0 and causal
                    and torch.device(device).type == "cuda")
        return False

    @property
    def storage_dtype(self) -> str:
        """The dtype parameters are stored in (param_dtype, else dtype)."""
        return self.param_dtype or self.dtype

    @property
    def mixed_precision(self) -> bool:
        return self.storage_dtype != self.dtype

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        """The kv heads a cache holds: ``n_kv_heads``, else ``n_heads``."""
        return self.n_kv_heads or self.n_heads


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default of
    every entry point; on a host without a usable CUDA device it raises
    instead of running on the CPU. Tests pass ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The world's shape (the JAX ``MeshConfig``): one process per (data,
    pipe, model, seq, expert) coordinate, axis order ('data', 'pipe',
    'model', 'seq', 'expert'), ranks row-major with the expert axis
    innermost. ``n_model`` above 1 splits each stage's blocks
    Megatron-style over the model group (``parallel.tensor_parallel``);
    ``n_seq`` above 1 splits each sequence over the seq group
    (``parallel.seq_parallel``); ``n_expert`` above 1 splits a MoE model's
    experts over the expert group, which also splits the batch
    (``parallel.expert_parallel``)."""

    n_pipe: int = 2
    n_data: int = 1
    n_model: int = 1
    n_seq: int = 1
    n_expert: int = 1

    @property
    def n_devices(self) -> int:
        return (self.n_pipe * self.n_data * self.n_model * self.n_seq
                * self.n_expert)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Pipeline schedule selection (the JAX ``ScheduleConfig``).

    ``name`` is "GPipe", "1F1B", "Interleaved1F1B" (the reference's
    three), "BFS", the zero-bubble "ZBH1" and "ZBV" (split backward; ZBV
    in the V placement, ``n_virtual=2``), or a name registered with
    ``parallel.schedules.register_schedule``. ``n_virtual`` is the number
    of virtual stages per device; :func:`virtual_stages_for` gives the
    reference's rule."""

    name: str = "GPipe"
    n_microbatches: int = 4
    n_virtual: int = 1

    def __post_init__(self):
        check_schedule_name(self.name)

    @classmethod
    def from_artifact(cls, source, *, name: Optional[str] = None
                      ) -> "ScheduleConfig":
        """Register a certified schedule artifact (a path or a parsed
        dict, from ``analysis.schedule_search``) and return the config that
        selects it: ``fit`` and the sweep then run exactly the certified
        table (``parallel.schedules.register_schedule_artifact``)."""
        from ..parallel.schedules import register_schedule_artifact
        cs = register_schedule_artifact(source, name=name)
        return cls(name=cs.name, n_microbatches=cs.n_microbatches,
                   n_virtual=cs.n_virtual)


def virtual_stages_for(schedule_name: str, n_layers: int, n_pipe: int) -> int:
    """The reference's stages-per-worker rule: 2 for Interleaved1F1B (and
    BFS) when ``n_layers % (2 * n_pipe) == 0``, else 1; ZBV always runs
    its 2 V-placed chunks, a registered schedule 1."""
    check_schedule_name(schedule_name)
    if schedule_name == "ZBV":
        return 2
    if (schedule_name in ("Interleaved1F1B", "BFS")
            and n_layers % (n_pipe * 2) == 0):
        return 2
    return 1


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One experiment's run parameters."""

    batch_size: int = 32
    seq_length: int = 128
    num_iterations: int = 5
    warmup_iterations: int = 2
    seed: int = 0
