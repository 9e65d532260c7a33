"""Flash attention (K2 + K4 forward, K3 + K5 backward): the wrappers of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, their plain versions,
their launch counts, and the differentiable ``flash_attention``.

Replaces four TPU kernels of
``distributed_training_with_pipeline_parallelism_tpu/ops/pallas_attention.py``:
``_flash_fwd_kernel`` / ``_flash_bwd_kernel`` (K2 / K3, the ``[b*h, s, dh]``
route for windows, ragged lengths and other head dims) and
``_flash_fwd_kernel_packed`` / ``_flash_bwd_kernel_packed`` (K4 / K5, the
head-packed route of plain causal full-length attention). Both CUDA kernels
read ``[b, s, h, dh]`` through the strides of the tensors they are given,
so each pair of routes is one kernel and neither pays a host-side
transpose. See the sources' notes for bounds and design.

bf16 runs on the tensor cores (``mma.sync`` on tiles staged by
``cp.async``), f32 on the CUDA cores (the exact gate: TF32 would not hold
its bounds). The bf16 kernels copy 16-byte rows, so every bf16 CUDA tensor
they read or write must start on a 16-byte boundary and have (batch, seq,
head) strides that are multiples of 8 elements; :func:`check_tc_alignment`
raises otherwise, naming the tensor and the stride, and nothing is copied.
The plain versions round where the bf16 kernels (and the TPU kernels)
round: q times scale*log2(e), p before p.v and p^T.do, and ds before ds.k
and ds^T.q.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ._build import Kernel
from .attention import NEG_INF, band_mask

FLASH_FWD = Kernel("flash_fwd.cu", {
    "flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_int64] * 12
                  + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
})
FLASH_BWD = Kernel("flash_bwd.cu", {
    "flash_bwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                  + [ctypes.POINTER(ctypes.c_int64),
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
})

# the head dims both kernels are built for (the backward covers every head
# dim the forward takes, so a differentiable call never builds a forward
# it cannot take backward)
HEAD_DIMS = (64, 96, 128, 192, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634
_DIM_NAMES = ("batch", "seq", "head")


def check_tc_alignment(fn: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every tensor ([b, s, h, dh], bf16)
    meets the rule of the tensor-core kernels' 16-byte ``cp.async``
    copies: its first element on a 16-byte boundary, and each of its
    (batch, seq, head) strides a multiple of 8 elements (a dimension of
    size 1 has no stride that matters). The message names the tensor and
    the stride."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(
                f"{fn}: {name} starts at byte address {x.data_ptr():#x}, "
                f"which is not 16-byte aligned (the bf16 tensor-core "
                f"kernels copy 16-byte rows)")
        for dim, (size, st) in enumerate(zip(x.shape[:3], x.stride()[:3])):
            if size > 1 and st % 8:
                raise ValueError(
                    f"{fn}: {name}'s {_DIM_NAMES[dim]} stride {st} is not a "
                    f"multiple of 8 elements (the bf16 tensor-core kernels "
                    f"copy 16-byte rows)")


def _plain_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: f32, or f64 for f64 inputs (which
    only the plain versions take, for ``torch.autograd.gradcheck``)."""
    return torch.promote_types(x.dtype, torch.float32)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None):
    """The kernel's function in plain PyTorch: q, k, v [b, s, h, dh] ->
    (o [b, s, h, dh] in q's dtype, lse [b, h, s] f32, natural log), f32
    scores masked to NEG_INF (the JAX ``_dense_attention`` arithmetic);
    f64 inputs compute in f64. bf16 inputs take the bf16 kernel's
    arithmetic (:func:`_flash_fwd_plain_bf16`)."""
    if q.dtype == torch.bfloat16:
        return _flash_fwd_plain_bf16(q, k, v, causal, window)
    dh = q.shape[-1]
    ct = _plain_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) / dh ** 0.5
    if causal:
        mask = band_mask(s.shape[-2], s.shape[-1], window, device=q.device)
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)).to(q.dtype)
    return o, lse


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 (nearest even) -> f32: where a bf16 kernel rounds an
    operand of its next product."""
    return x.to(torch.bfloat16).float()


def _scores_log2(q: torch.Tensor, k: torch.Tensor, causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """The bf16 kernels' masked scores [b, h, s, s] in the exp2 domain:
    q scaled by scale*log2(e) in f32 and rounded to bf16 (the JAX kernels'
    ``qc``), times k, accumulated in f32."""
    c = LOG2E / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", _bf16_round(q.float() * c), k.float())
    if causal:
        mask = band_mask(s.shape[-2], s.shape[-1], window, device=q.device)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _flash_fwd_plain_bf16(q, k, v, causal, window):
    """The bf16 kernel's arithmetic: exp2-domain scores from the rounded
    scaled q, p = exp2(s - m) in f32 with its row sum l in f32, p rounded
    to bf16 for p.v, o = (p.v) / l cast to bf16, lse = (m + log2 l) ln 2.
    The kernel takes p against a running max over its key tiles, here
    against the row's max, so a rounding of p may differ by one ulp."""
    s = _scores_log2(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _bf16_round(p), v.float())
    o = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return o, (m[..., 0] + torch.log2(l)) * math.log(2.0)


def _check_cuda(q, k, v, fn="flash_fwd"):
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and "
                             f"device (expand GQA heads first), got "
                             f"{tuple(x.shape)} {x.dtype} {x.device} vs "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{fn} has kernels for head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(f"{fn} needs a contiguous head_dim")
    if q.dtype == torch.bfloat16:
        check_tc_alignment(fn, {"q": q, "k": k, "v": v})


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


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool = False, window: Optional[int] = None):
    """The backward kernel's function in plain PyTorch, in f32 from the
    saved ``lse`` [b, h, s]: p = exp(s - lse), dp = do.v^T,
    delta = rowsum(do * o), ds = p * (dp - delta); dq = scale * ds.k,
    dk = scale * ds^T.q, dv = p^T.do, each cast to q's dtype. bf16 inputs
    take the bf16 kernel's arithmetic: exp2-domain scores from the rounded
    scaled q, p rounded to bf16 for p^T.do, ds rounded to bf16 for ds.k
    and ds^T.q."""
    scale = 1.0 / q.shape[-1] ** 0.5
    if q.dtype == torch.bfloat16:
        qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, do))
        p = torch.exp2(_scores_log2(q, k, causal, window)
                       - lse.float()[..., None] * LOG2E)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
        delta = (gf * of).sum(-1).transpose(1, 2)  # [b, h, s]
        ds = _bf16_round(p * (dp - delta[..., None]))
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        dv = torch.einsum("bhqk,bqhd->bkhd", _bf16_round(p), gf)
        return tuple(x.to(q.dtype) for x in (dq, dk, dv))
    ct = _plain_dtype(q)
    qf, kf, vf, of, gf = (x.to(ct) for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = band_mask(s.shape[-2], s.shape[-1], window, device=q.device)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.to(ct)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).transpose(1, 2)  # [b, h, s]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = False, window: Optional[int] = None):
    """(dq, dk, dv) [b, s, h, dh] in q's dtype from q, k, v, the forward's
    o and lse [b, h, s] f32 (natural log) and the cotangent ``do``, for the
    attention :func:`flash_fwd` computed with the same ``causal`` and
    ``window``. Any strides over b, s and h; a ``do`` whose head_dim is not
    contiguous is made contiguous first."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and window >= 1")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on CUDA (or its plain version on "
                         f"the CPU), got {q.device}")
    _check_cuda(q, k, v, "flash_bwd")
    b, s, h, dh = q.shape
    if (o.shape != q.shape or do.shape != q.shape
            or lse.shape != (b, h, s)):
        raise ValueError(f"flash_bwd: o and do must be {tuple(q.shape)} and "
                         f"lse {(b, h, s)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)} and {tuple(lse.shape)}")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if o.stride(-1) != 1 or o.dtype != q.dtype:
        raise ValueError("flash_bwd needs o in q's dtype with a contiguous "
                         "head_dim")
    if q.dtype == torch.bfloat16:
        check_tc_alignment("flash_bwd", {"o": o, "do": do})
    lse = lse.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*[
        st for x in (q, k, v, o, do, dq, dk, dv) for st in x.stride()[:3]])
    FLASH_BWD.call("flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), _DTYPE_CODE[q.dtype], b, s, h, dh, strides,
                   int(causal), window or 0,
                   torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with the saved-(o, lse) backward (the JAX ``_flash`` /
    ``_flash_packed`` custom_vjp): forward ``flash_fwd``, backward
    ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention: q, k, v [batch, seq, heads, head_dim] -> same shape
    (the contract of the JAX ``flash_attention``; GQA heads are expanded
    before the call).

    ``window`` (requires ``causal``) applies the sliding-window band. An
    explicit ``block_q``/``block_k`` is a tiling choice, not a change of
    the function: any block up to the sequence length gives the same
    result (the kernels keep their own tiling), and a block larger than
    the sequence raises, as in the JAX package. Differentiable in q, k
    and v through :func:`flash_bwd`.
    """
    s = q.shape[1]
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and blk > s:
            raise ValueError(
                f"explicit {name}={blk} exceeds the sequence length {s}; "
                f"pass {name}=None for the kernel's own tiling")
    return _FlashAttention.apply(q, k, v, causal, window)
