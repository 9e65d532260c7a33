"""Model configuration for the PyTorch port.

The port's own copy of the fields of
``distributed_training_with_pipeline_parallelism_tpu/utils/config.py:ModelConfig``
that the GPT-2 decode and training slices read, under the same names, with
the same defaults and the same validation (the llama-only fields, such as
``n_kv_heads`` and ``sliding_window``, come with the llama arch), plus
``ScheduleConfig``, ``virtual_stages_for`` and ``RunConfig``. The one
behavioural difference is :meth:`ModelConfig.flash_for`: the JAX package's ``"auto"`` cut-over
(causal, seq >= 1024, TPU only) is a TPU measurement and does not carry
over; here ``"auto"`` picks the hand-written kernel for every causal call
on a CUDA tensor and the plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..parallel.schedules import check_schedule_name


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer LM hyperparameters (see the module doc).

    ``arch`` accepts the JAX package's three block families so configs
    stay interchangeable; the port's model implements ``"gpt2"`` and
    raises ``NotImplementedError`` for the others.
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

    def __post_init__(self):
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} must be divisible by n_heads={self.n_heads}")
        if self.arch not in ("ref_decoder", "gpt2", "llama"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must be in [0, 1)")
        if self.use_flash_attention not in (True, False, "auto"):
            raise ValueError(
                f"use_flash_attention={self.use_flash_attention!r} must be "
                f"True, False, or 'auto'")
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
        return self.dim // self.n_heads


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
class ScheduleConfig:
    """Pipeline schedule selection (the JAX ``ScheduleConfig``).

    ``name`` is one of the port's schedules: "GPipe", "1F1B",
    "Interleaved1F1B" (the reference's three) or "BFS". ``n_virtual`` is
    the number of virtual stages per device; :func:`virtual_stages_for`
    gives the reference's rule."""

    name: str = "GPipe"
    n_microbatches: int = 4
    n_virtual: int = 1

    def __post_init__(self):
        check_schedule_name(self.name)


def virtual_stages_for(schedule_name: str, n_layers: int, n_pipe: int) -> int:
    """The reference's stages-per-worker rule: 2 for Interleaved1F1B (and
    BFS) when ``n_layers % (2 * n_pipe) == 0``, else 1."""
    check_schedule_name(schedule_name)
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
