"""Fused softmax cross-entropy forward (K1): the wrapper of
``csrc/xent_fwd.cu``, its plain version and its launch count.

Replaces ``distributed_training_with_pipeline_parallelism_tpu/ops/pallas_xent.py``
``_xent_fwd_kernel`` (via ``_xent_fwd_pallas``). The kernel computes the
per-row logsumexp and target logit of ``[N, V]`` logits without writing
the ``[N, V]`` log-softmax; see the source note for its bound and design.
A CPU tensor takes :func:`xent_fwd_plain`; a CUDA tensor launches the
kernel or raises. The backward (``_xent_vjp_bwd``) belongs to the
training slice and is not here.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel

XENT_FWD = Kernel("xent_fwd.cu", {
    "xent_fwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int64, ctypes.c_void_p],
})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def xent_fwd_plain(logits: torch.Tensor, targets: torch.Tensor):
    """The kernel's function in plain PyTorch: logits [N, V], targets [N]
    -> (nll [N] f32, lse [N] f32), with the JAX kernel's arithmetic
    (max-shifted logsumexp; a target outside [0, V) gathers 0)."""
    x = logits.float()
    m = x.max(dim=1).values
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=1))
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    tl = torch.where(cols == targets.long()[:, None], x, 0.0).sum(dim=1)
    return lse - tl, lse


def xent_fwd(logits: torch.Tensor, targets: torch.Tensor):
    """logits [N, V] (f32 or bf16, contiguous vocab dim), targets [N] int
    -> (nll [N] f32, lse [N] f32)."""
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"logits must be [N, V] and targets [N], got "
                         f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    if logits.device.type == "cpu":
        return xent_fwd_plain(logits, targets)
    if logits.device.type != "cuda" or targets.device != logits.device:
        raise ValueError(f"xent_fwd runs on CUDA (or its plain version on "
                         f"the CPU), got logits on {logits.device} and "
                         f"targets on {targets.device}")
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"xent_fwd takes float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    if logits.stride(1) != 1:
        raise ValueError("xent_fwd needs a contiguous vocab dim")
    n, v = logits.shape
    nll = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    if n == 0:
        return nll, lse
    tg = targets.to(torch.int64).contiguous()
    XENT_FWD.call("xent_fwd", logits.data_ptr(), tg.data_ptr(),
                  nll.data_ptr(), lse.data_ptr(), _DTYPE_CODE[logits.dtype],
                  n, v, logits.stride(0),
                  torch.cuda.current_stream(logits.device).cuda_stream)
    return nll, lse


def fused_softmax_xent(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL through the fused kernel: [..., V] x [...] -> [...]
    f32 (the forward of the JAX ``fused_softmax_xent``)."""
    v = logits.shape[-1]
    nll, _ = xent_fwd(logits.reshape(-1, v), targets.reshape(-1))
    return nll.reshape(targets.shape)

