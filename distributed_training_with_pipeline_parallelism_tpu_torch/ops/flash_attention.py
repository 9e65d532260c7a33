"""Flash-attention forward (K2 + K4): the wrapper of ``csrc/flash_fwd.cu``,
its plain version and its launch count.

Replaces two TPU kernels of
``distributed_training_with_pipeline_parallelism_tpu/ops/pallas_attention.py``:
``_flash_fwd_kernel`` (K2, the ``[b*h, s, dh]`` route for windows, ragged
lengths and other head dims) and ``_flash_fwd_kernel_packed`` (K4, the
head-packed route of plain causal full-length attention). The CUDA kernel
reads ``[b, s, h, dh]`` through the strides of the tensors it is given, so
both routes are one kernel and neither pays a host-side transpose. See the
source note for its bound and design.

A CPU tensor takes :func:`flash_fwd_plain`; a CUDA tensor launches the
kernel or raises. The backward kernels (K3, K5) belong to the training
slice and are not here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import Kernel
from .attention import NEG_INF, band_mask

FLASH_FWD = Kernel("flash_fwd.cu", {
    "flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_int64] * 12
                  + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
})

# the kernel's tiles: 64 query rows per block of threads, 64 keys per
# staged K/V tile (the port's own choice; the JAX _auto_block is a v5e
# measurement)
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None):
    """The kernel's function in plain PyTorch: q, k, v [b, s, h, dh] ->
    (o [b, s, h, dh] in q's dtype, lse [b, h, s] f32, natural log), f32
    scores masked to NEG_INF (the JAX ``_dense_attention`` arithmetic)."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / dh ** 0.5
    if causal:
        mask = band_mask(s.shape[-2], s.shape[-1], window, device=q.device)
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return o, lse


def _check_cuda(q, k, v):
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and "
                             f"device (expand GQA heads first), got "
                             f"{tuple(x.shape)} {x.dtype} {x.device} vs "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_fwd has kernels for head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_fwd needs a contiguous head_dim")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: Optional[int] = None):
    """q, k, v [b, s, h, dh] (any strides over b, s and h) ->
    (o [b, s, h, dh], lse [b, h, s] f32, natural log). ``window``
    requires ``causal``, on either device, so the kernel and its plain
    version compute one function."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and window >= 1")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA (or its plain version on "
                         f"the CPU), got {q.device}")
    _check_cuda(q, k, v)
    b, s, h, dh = q.shape
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = [st for x in (q, k, v, o) for st in x.stride()[:3]]
    FLASH_FWD.call("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype],
                   b, s, h, dh, *strides, int(causal), window or 0,
                   torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention: q, k, v [batch, seq, heads, head_dim] -> same shape
    (the contract of the JAX ``flash_attention``; GQA heads are expanded
    before the call).

    ``window`` (requires ``causal``) applies the sliding-window band. An
    explicit ``block_q``/``block_k`` larger than the sequence raises, as
    in the JAX package. The CUDA kernel has one tiling, ``BLOCK_Q`` x
    ``BLOCK_K``; an explicit block other than that raises on a CUDA
    tensor rather than being silently ignored. The plain version on the
    CPU is blockless and takes any block up to the sequence length.
    """
    s = q.shape[1]
    for name, blk, tile in (("block_q", block_q, BLOCK_Q),
                            ("block_k", block_k, BLOCK_K)):
        if blk is None:
            continue
        if blk > s:
            raise ValueError(
                f"explicit {name}={blk} exceeds the sequence length {s}; "
                f"pass {name}=None for the kernel's own tiling")
        if q.device.type == "cuda" and blk != tile:
            raise ValueError(f"the CUDA flash kernel tiles {name}={tile}; "
                             f"got an explicit {name}={blk}")
    return flash_fwd(q, k, v, causal, window)[0]
