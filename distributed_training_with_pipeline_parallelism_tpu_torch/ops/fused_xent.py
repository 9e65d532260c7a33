"""Fused softmax cross-entropy (K1 and its backward): the wrappers of
``csrc/xent_fwd.cu`` and ``csrc/xent_bwd.cu``, their plain versions, their
launch counts, and the differentiable op that pairs them.

Replaces ``distributed_training_with_pipeline_parallelism_tpu/ops/pallas_xent.py``:
``_xent_fwd_kernel`` (K1, via ``_xent_fwd_pallas``) computes the per-row
logsumexp and target logit of ``[N, V]`` logits without writing the
``[N, V]`` log-softmax; ``_xent_vjp_bwd`` (an XLA fusion on the TPU) turns
the saved ``lse`` into the logits' gradient in one read-logits /
write-grad pass. See the sources' notes for bounds and design.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
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
XENT_BWD = Kernel("xent_bwd.cu", {
    "xent_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def xent_fwd_plain(logits: torch.Tensor, targets: torch.Tensor):
    """The kernel's function in plain PyTorch: logits [N, V], targets [N]
    -> (nll [N] f32, lse [N] f32), with the JAX kernel's arithmetic
    (max-shifted logsumexp; a target outside [0, V) gathers 0); f64
    logits compute in f64."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = x.max(dim=1).values
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=1))
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    tl = torch.where(cols == targets.long()[:, None], x, 0.0).sum(dim=1)
    return lse - tl, lse


def _check_rows(name: str, logits: torch.Tensor, *rows: torch.Tensor) -> None:
    if logits.dim() != 2 or any(r.shape != logits.shape[:1] for r in rows):
        raise ValueError(f"{name}: logits must be [N, V] and each row "
                         f"vector [N], got {tuple(logits.shape)} and "
                         f"{[tuple(r.shape) for r in rows]}")


def _check_cuda(name: str, logits: torch.Tensor, *rows: torch.Tensor) -> None:
    if logits.device.type != "cuda" or any(r.device != logits.device
                                           for r in rows):
        raise ValueError(f"{name} runs on CUDA (or its plain version on the "
                         f"CPU), got logits on {logits.device} and row "
                         f"vectors on {[str(r.device) for r in rows]}")
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    if logits.stride(1) != 1:
        raise ValueError(f"{name} needs a contiguous vocab dim")


def xent_fwd(logits: torch.Tensor, targets: torch.Tensor):
    """logits [N, V] (f32 or bf16, contiguous vocab dim), targets [N] int
    -> (nll [N] f32, lse [N] f32)."""
    _check_rows("xent_fwd", logits, targets)
    if logits.device.type == "cpu":
        return xent_fwd_plain(logits, targets)
    _check_cuda("xent_fwd", logits, targets)
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


def xent_bwd_plain(logits: torch.Tensor, targets: torch.Tensor,
                   lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch:
    ``(exp(x - lse) - onehot(t)) * g`` in f32, cast to the logits dtype
    (the JAX ``_xent_vjp_bwd``). A row with ``g = 0`` is exactly 0."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    onehot = (cols == targets.long()[:, None]).to(x.dtype)
    grad = (torch.exp(x - lse[:, None]) - onehot) * g.to(x.dtype)[:, None]
    grad = torch.where(g[:, None] == 0, 0.0, grad)  # +0, never -0
    return grad.to(logits.dtype)


def xent_bwd(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """The logits' gradient [N, V] in their dtype from the logits, the
    targets, the forward's ``lse`` [N] f32 and the cotangent ``g`` [N] of
    the per-row NLL."""
    _check_rows("xent_bwd", logits, targets, lse, g)
    if logits.device.type == "cpu":
        return xent_bwd_plain(logits, targets, lse, g)
    _check_cuda("xent_bwd", logits, targets, lse, g)
    n, v = logits.shape
    grad = torch.empty((n, v), dtype=logits.dtype, device=logits.device)
    if n == 0:
        return grad
    tg = targets.to(torch.int64).contiguous()
    # the cotangent of a mean arrives as an expanded scalar (stride 0)
    g = g.to(torch.float32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    XENT_BWD.call("xent_bwd", logits.data_ptr(), tg.data_ptr(),
                  lse.data_ptr(), g.data_ptr(), grad.data_ptr(),
                  _DTYPE_CODE[logits.dtype], n, v, logits.stride(0),
                  grad.stride(0),
                  torch.cuda.current_stream(logits.device).cuda_stream)
    return grad


class _FusedXent(torch.autograd.Function):
    """Per-row NLL with the saved-lse backward (the JAX ``_xent``
    custom_vjp): forward ``xent_fwd``, backward ``xent_bwd``."""

    @staticmethod
    def forward(ctx, logits, targets):
        nll, lse = xent_fwd(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return xent_bwd(logits, targets, lse, g), None


def fused_softmax_xent(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL through the fused kernels: [..., V] x [...] -> [...]
    f32, differentiable in the logits."""
    v = logits.shape[-1]
    nll = _FusedXent.apply(logits.reshape(-1, v), targets.reshape(-1))
    return nll.reshape(targets.shape)


def fused_cross_entropy_loss(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """``ops.layers.cross_entropy_loss`` through the fused kernels."""
    return fused_softmax_xent(logits, targets).mean()


def fused_masked_xent_sum(logits: torch.Tensor, targets: torch.Tensor,
                          pad_id: int):
    """``ops.layers.masked_xent_sum`` through the fused kernels: the mask
    acts on the per-token NLL, so pad rows get a zero cotangent and an
    exactly zero logit gradient."""
    nll = fused_softmax_xent(logits, targets)
    valid = targets != pad_id
    return torch.where(valid, nll, 0.0).sum(), valid.sum()
