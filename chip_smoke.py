#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device (H100-class, sm_90a), ``nvcc`` and ``nvidia-smi``.
Run from the root of a checkout: it imports the port
(``distributed_training_with_pipeline_parallelism_tpu_torch``) and never
JAX. Phases, each fatal on failure:

1. Device and toolchain: the card's name and power limit, the CUDA and
   nvcc versions; build every kernel from ``csrc/`` (one nvcc per source,
   all started together); each kernel's registers and spills as ptxas
   reports them, and no spill in a tensor-core kernel (``*_tc``).
2. Every kernel against its plain PyTorch version on the card at the
   decode and training paths' shapes, with stated tolerances, timed beside
   its plain version, its bound and one library call that computes the
   same function (a yardstick only; the port never calls it; the device
   kernels it ran are recorded by name). The attention kernels' achieved
   TFLOP/s are recorded beside their times.
3. The decode path: GPT-2-small at full width, random weights from a seed,
   D = 4 lockstep pipeline stages, M = 4 streams, B = 16 prompts of 512
   tokens, 32 new tokens, greedy, log-probs through the fused-xent
   kernel, prefill through the flash kernel. In f32 the kernel run must
   give the tokens of a run on the plain paths and of the single-device
   ``generate`` (a mismatch only where the reference's top-2 logit gap is
   below 1e-4), with log-probs within 1e-4; both kernels must have been
   launched. In bf16 one counted run must launch both kernels, and the
   prefill time and decode tokens/s are measured.
4. The training path: tied GPT-2-small (124M) at full width, random
   weights from a seed, B = 24 sequences of 1024 tokens, M = 4
   microbatches. In f32, one pipelined 1F1B step at D = 4 through all four
   kernels must match the same step on the plain versions and
   single-device autograd of ``transformer_loss`` (loss and every
   gradient leaf), and each kernel's launches must be the count the tick
   table predicts. The same step in bf16 compute (f32 master weights),
   through the kernels (bf16 attention on the tensor cores), must match the
   step on the plain versions in bf16 (loss within 1e-2 relative, each
   gradient leaf within 5e-2 of its norm plus 1e-3 of the global norm)
   with the same launch counts. In bf16 ``make_train_step`` with
   ``adamw`` runs 2 warm-up and 5 timed steps under GPipe (D = 4), 1F1B
   (D = 4) and Interleaved1F1B (D = 2, V = 2): tokens/s, the analytic
   bubble and every step's loss, which must be finite and fall; one step
   runs under the profiler for its idle share.

Then it prints the kernel record as one JSON line (times at the training
shape in bf16; launches from the counted bf16 runs, which take the
tensor-core attention kernels that are timed), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
Details go to ``chip_smoke_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = "distributed_training_with_pipeline_parallelism_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores / f32 FMA
B, P, N, D, M = 16, 512, 32, 4, 4
# the training path: the JAX bench rung gpt2_small_seq1024_bs24, over stages
TRAIN_B, TRAIN_S, TRAIN_M = 24, 1024, 4
TRAIN_SHAPE = [TRAIN_B // TRAIN_M, TRAIN_S, 12, 64]  # one microbatch's q/k/v
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call, after three warm-up calls: the summed time
    of the CUDA kernels that a ``torch.profiler`` trace of ``iters`` calls
    records, per call, so the host's gaps between launches are excluded.
    A trace now and then comes back empty (seen on the H100 host after
    some dozens of profiler sessions in one process), so an empty trace is
    taken again, up to three times in all; fails if none records device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        if dev_us > 0:
            return dev_us / 1e3 / iters
    raise SmokeFailure("torch.profiler recorded no device time in three "
                       "traces")


def device_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` runs on the device
    (after a warm-up call), as ``torch.profiler`` records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:160] for e in prof.key_averages()
                   if e.self_device_time_total > 0})


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def all_kernels():
    """Every kernel of the port, in the kernel line's order."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_BWD, XENT_FWD)
    return (FLASH_FWD, XENT_FWD, FLASH_BWD, XENT_BWD)


def main_config():
    """GPT-2-small at full width, with both kernels routed."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import gpt2_config
    return gpt2_config("small", use_flash_attention="auto",
                       use_fused_xent=True)


def ptxas_usage(build_log: str):
    """One row per compiled entry function of an ``nvcc -Xptxas=-v`` log:
    its (mangled) symbol, registers and spill bytes."""
    import re
    rows = []
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            rows.append(dict(function=m.group(1), registers=None,
                             spill_stores=0, spill_loads=0))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and rows:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def phase_toolchain(report):
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops._build import (
        build_all, nvcc_version)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    report["nvcc"] = nvcc_version()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"{report['nvcc']}")
    t0 = time.perf_counter()
    kernels = all_kernels()
    build_all(kernels)
    report["build_s"] = time.perf_counter() - t0
    print(f"built {', '.join(k.source.name for k in kernels)} in "
          f"{report['build_s']:.1f} s")
    report["ptxas"] = {k.name: ptxas_usage(k.build_log) for k in kernels}
    for name, rows in report["ptxas"].items():
        for r in rows:
            print(f"  ptxas {name}: {r['function']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, loads {r['spill_loads']} B")
    spilled = [r["function"] for rows in report["ptxas"].values() for r in rows
               if "_tc" in r["function"] and r["spill_stores"] + r["spill_loads"]]
    check(not spilled, f"ptxas spilled registers in {spilled}")


def phase_kernels(report):
    """Each kernel against its plain version on the card; returns the
    records of the training path's shapes (this slice's main path; the
    decode path's shapes are checked and timed too)."""
    import torch
    import torch.nn.functional as F
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.attention import band_mask
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        xent_bwd, xent_bwd_plain, xent_fwd, xent_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def flash_case(b, s, h, dh, dtype, causal, window, layout, tol):
        dt = getattr(torch, dtype)
        if layout == "packed":  # [b, s, h*dh] as the projection writes it
            mk = lambda: torch.randn(b, s, h * dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).view(b, s, h, dh)
        else:  # [b, h, s, dh] storage read through [b, s, h, dh] strides
            mk = lambda: torch.randn(b, h, s, dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).transpose(1, 2)
        q, k, v = mk(), mk(), mk()
        o, lse = flash_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, window)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        check(torch.isfinite(o).all().item(), "flash: non-finite output")
        check(err <= tol, f"flash {layout} {[b, s, h, dh]} {dtype} causal="
              f"{causal} window={window}: max |o - plain| {err} > {tol}")
        check(lse_err <= 1e-3, f"flash: lse differs from plain by {lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
        else:
            mask = band_mask(s, s, window, device="cuda")
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        if causal:
            w = window or s
            pairs = sum(min(i + 1, w) for i in range(s))
        else:
            pairs = s * s
        itemsize = q.element_size()
        flops = 4 * b * h * dh * pairs
        bms, by = bound(4 * b * s * h * dh * itemsize + b * h * s * 4,
                        flops, dtype)
        rec = dict(kernel="flash_fwd", shape=[b, s, h, dh], dtype=dtype,
                   causal=causal, window=window, layout=layout,
                   max_abs_err=err, tol=tol, bound_ms=bms, bound_by=by)
        if dtype == "bfloat16":
            # a reading, not a check: the error in bf16 ulps of each output
            # row's largest |o_plain| (the bf16 ulp of x is 2^(e - 7) for
            # x in [2^e, 2^(e+1)))
            row_max = o_ref.float().abs().amax(-1).clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
            rec["row_ulp_err"] = ((o.float() - o_ref.float()).abs().amax(-1)
                                  / ulp).max().item()
        rec["ms"] = time_ms(lambda: flash_fwd(q, k, v, causal, window))
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["plain_ms"] = time_ms(lambda: flash_fwd_plain(q, k, v, causal,
                                                          window))
        rec["library_ms"] = time_ms(lib)
        if [b, s, h, dh] == TRAIN_SHAPE:
            rec["library_kernels"] = device_kernels(lib)
        rows.append(rec)
        return rec

    def xent_case(n, v, dtype, rtol):
        dt = getattr(torch, dtype)
        logits = 3 * torch.randn(n, v, generator=gen, device="cuda", dtype=dt)
        tg = torch.randint(0, v, (n,), generator=gen, device="cuda")
        nll, lse = xent_fwd(logits, tg)
        torch.cuda.synchronize()
        nll_ref, lse_ref = xent_fwd_plain(logits, tg)
        rel = ((nll - nll_ref).abs() / nll_ref.abs().clamp_min(1.0)).max().item()
        err = (nll - nll_ref).abs().max().item()
        lse_rel = ((lse - lse_ref).abs() / lse_ref.abs()).max().item()
        check(rel <= rtol and lse_rel <= rtol,
              f"xent {[n, v]} {dtype}: relative nll err {rel}, lse err "
              f"{lse_rel} > {rtol}")
        itemsize = logits.element_size()
        bms, by = bound(n * v * itemsize + n * 8 + 2 * n * 4, 4 * n * v,
                        "float32")
        rec = dict(kernel="xent_fwd", shape=[n, v], dtype=dtype,
                   max_abs_err=err, rel_err=rel, rtol=rtol, bound_ms=bms,
                   bound_by=by)
        rec["ms"] = time_ms(lambda: xent_fwd(logits, tg), 50)
        rec["plain_ms"] = time_ms(lambda: xent_fwd_plain(logits, tg), 50)
        rec["library_ms"] = time_ms(lambda: F.cross_entropy(
            logits, tg, reduction="none"), 50)
        rows.append(rec)
        return rec

    def causal_pairs(s, causal, window):
        if not causal:
            return s * s
        w = window or s
        return sum(min(i + 1, w) for i in range(s))

    def rel_err(got, want):
        """max |got - want| over max |want|, both as f32."""
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    def flash_bwd_case(b, s, h, dh, dtype, causal, window, layout, rtol):
        dt = getattr(torch, dtype)
        if layout == "packed":
            mk = lambda: torch.randn(b, s, h * dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).view(b, s, h, dh)
        else:  # [b, h, s, dh] storage, the cotangent too
            mk = lambda: torch.randn(b, h, s, dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).transpose(1, 2)
        q, k, v, do = mk(), mk(), mk(), mk()
        o, lse = flash_fwd(q, k, v, causal, window)
        got = flash_bwd(q, k, v, o, lse, do, causal, window)
        torch.cuda.synchronize()
        want = flash_bwd_plain(q, k, v, o, lse, do, causal, window)
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        check(all(torch.isfinite(x).all().item() for x in got),
              "flash_bwd: non-finite gradient")
        check(max(errs) <= rtol, f"flash_bwd {layout} {[b, s, h, dh]} {dtype} "
              f"causal={causal} window={window}: max |d - plain| / max "
              f"|plain| (dq, dk, dv) {errs} > {rtol}")
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        if window is None:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        else:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band_mask(s, s, window, device="cuda"))
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                          retain_graph=True)
        # the algorithm's five products (the two-kernel form runs seven)
        flops = 10 * b * h * dh * causal_pairs(s, causal, window)
        bms, by = bound(8 * b * s * h * dh * q.element_size() + b * h * s * 4,
                        flops, dtype)
        err = max((x.float() - w.float()).abs().max().item()
                  for x, w in zip(got, want))
        rec = dict(kernel="flash_bwd", shape=[b, s, h, dh], dtype=dtype,
                   causal=causal, window=window, layout=layout,
                   max_abs_err=err, rel_err=max(errs), rtol=rtol,
                   bound_ms=bms, bound_by=by)
        rec["ms"] = time_ms(lambda: flash_bwd(q, k, v, o, lse, do, causal,
                                              window))
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["plain_ms"] = time_ms(lambda: flash_bwd_plain(
            q, k, v, o, lse, do, causal, window), 5)
        rec["library_ms"] = time_ms(lib)
        if [b, s, h, dh] == TRAIN_SHAPE:
            rec["library_kernels"] = device_kernels(lib)
        rows.append(rec)
        return rec

    def xent_bwd_case(n, v, dtype, rtol, pad_row=None):
        dt = getattr(torch, dtype)
        logits = 3 * torch.randn(n, v, generator=gen, device="cuda", dtype=dt)
        tg = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.rand(n, generator=gen, device="cuda") / n
        if pad_row is not None:
            g[pad_row] = 0.0
        _, lse = xent_fwd(logits, tg)
        got = xent_bwd(logits, tg, lse, g)
        torch.cuda.synchronize()
        want = xent_bwd_plain(logits, tg, lse, g)
        rel = rel_err(got, want)
        check(torch.isfinite(got).all().item(), "xent_bwd: non-finite")
        check(rel <= rtol, f"xent_bwd {[n, v]} {dtype}: max |grad - plain| / "
              f"max |plain| {rel} > {rtol}")
        if pad_row is not None:
            check(bool((got[pad_row] == 0).all()),
                  "xent_bwd: a pad row's gradient is not exactly 0")
        x = logits.detach().requires_grad_()
        nll = F.cross_entropy(x, tg, reduction="none")
        lib = lambda: torch.autograd.grad(nll, x, g, retain_graph=True)  # noqa: E731
        itemsize = logits.element_size()
        bms, by = bound(2 * n * v * itemsize + n * (8 + 4 + 4), 4 * n * v,
                        "float32")
        rec = dict(kernel="xent_bwd", shape=[n, v], dtype=dtype,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   rel_err=rel, rtol=rtol, pad_row=pad_row, bound_ms=bms,
                   bound_by=by)
        rec["ms"] = time_ms(lambda: xent_bwd(logits, tg, lse, g))
        rec["plain_ms"] = time_ms(lambda: xent_bwd_plain(logits, tg, lse, g),
                                  5)
        rec["library_ms"] = time_ms(lib)
        rows.append(rec)
        return rec

    tol = {"float32": 2e-5, "bfloat16": 2e-2}
    main = {}
    for dtype in ("bfloat16", "float32"):
        # the training path's attention: one microbatch of B/M sequences
        main[("flash_fwd", dtype)] = flash_case(
            *TRAIN_SHAPE, dtype, True, None, "packed",
            tol[dtype])
        # the decode path's prefill: one stream of B/M prompts per stage call
        flash_case(B // M, P, 12, 64, dtype, True, None, "packed", tol[dtype])
        flash_case(16, 512, 12, 64, dtype, True, None, "packed", tol[dtype])
        # the K2 route: a window, a ragged length, head_dim 128, transposed
        flash_case(2, 1000, 8, 128, dtype, True, 256, "transposed",
                   tol[dtype])
        flash_case(2, 256, 4, 64, dtype, False, None, "packed", tol[dtype])
        flash_case(1, 130, 2, 256, dtype, True, None, "transposed",
                   tol[dtype])
    for dtype, rtol in (("bfloat16", 1e-3), ("float32", 1e-5)):
        # the training path's loss: one microbatch's rows of the vocab
        main[("xent_fwd", dtype)] = xent_case(TRAIN_B // TRAIN_M * TRAIN_S,
                                              50257, dtype, rtol)
        # the decode path's head: B/M rows per stage call
        xent_case(B // M, 50257, dtype, rtol)
        xent_case(7, 50257, dtype, rtol)
    # backward tolerances, relative to the largest reference gradient:
    # f32 differs by summation order only; bf16 outputs round once (one
    # bf16 ulp is 2^-8 of the value)
    bwd_tol = {"float32": 1e-4, "bfloat16": 1e-2}
    for dtype in ("bfloat16", "float32"):
        # the training path's attention: one microbatch of B/M sequences
        main[("flash_bwd", dtype)] = flash_bwd_case(
            *TRAIN_SHAPE, dtype, True, None, "packed",
            bwd_tol[dtype])
        # the K3 route: a window, a ragged length, head_dim 128, transposed
        flash_bwd_case(2, 1000, 8, 128, dtype, True, 256, "transposed",
                       bwd_tol[dtype])
        flash_bwd_case(2, 256, 4, 64, dtype, False, None, "packed",
                       bwd_tol[dtype])
        flash_bwd_case(1, 130, 2, 256, dtype, True, None, "transposed",
                       bwd_tol[dtype])
        # the training path's head: one microbatch's rows of the vocab
        main[("xent_bwd", dtype)] = xent_bwd_case(
            TRAIN_B // TRAIN_M * TRAIN_S, 50257, dtype, bwd_tol[dtype])
        xent_bwd_case(7, 50257, dtype, bwd_tol[dtype], pad_row=3)
    for r in rows:
        print(f"  {r['kernel']} {r['shape']} {r['dtype']}"
              + (f" causal={r['causal']} window={r['window']} {r['layout']}"
                 if r["kernel"].startswith("flash") else "")
              + f": max_abs_err {r['max_abs_err']:.3g}"
              + (f" ({r['row_ulp_err']:.2f} ulp of its row's max)"
                 if "row_ulp_err" in r else "")
              + "  kernel "
              f"{r['ms']:.4f} ms"
              + (f" ({r['tflops']:.1f} TFLOP/s)" if "tflops" in r else "")
              + f"  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  library "
              f"{r['library_ms']:.4f} ms")
    for r in rows:
        if "library_kernels" in r:
            print(f"  library yardstick of {r['kernel']} {r['dtype']} ran: "
                  f"{r['library_kernels']}")
    report["kernel_checks"] = rows
    return main


def compare_tokens(name, toks, ref, lps, ref_lps, gap, lp_tol=1e-4,
                   gap_tol=1e-4):
    """Rows must agree with ``ref`` token for token; a row may part only at
    a step where the reference's top-2 logit gap is below ``gap_tol`` and
    is not compared past it. Log-probs agree within ``lp_tol`` up to
    there. Returns the rows that parted at a near-tie."""
    new, ref_new = toks[:, P:], ref[:, P:]
    parted = []
    worst_lp = 0.0
    for r in range(new.shape[0]):
        diff = (new[r] != ref_new[r]).nonzero()
        j = int(diff[0]) if len(diff) else N
        if j < N:
            check(gap[r, j].item() < gap_tol,
                  f"{name}: row {r} step {j}: token {int(new[r, j])} vs "
                  f"{int(ref_new[r, j])} with top-2 gap {gap[r, j].item()}")
            parted.append(dict(row=r, step=j, gap=gap[r, j].item()))
        if j:
            worst_lp = max(worst_lp,
                           (lps[r, :j] - ref_lps[r, :j]).abs().max().item())
    check(worst_lp <= lp_tol,
          f"{name}: log-probs differ by {worst_lp} > {lp_tol}")
    print(f"  {name}: tokens agree "
          f"({len(parted)} rows part at near-ties: {parted}); "
          f"max |logprob diff| {worst_lp:.3g}")
    return dict(parted=parted, max_lp_diff=worst_lp)


def phase_main_path(report, device="cuda"):
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_apply)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_FWD)
    kernels = (FLASH_FWD, XENT_FWD)
    cfg = main_config()
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    model = port.init_params(cfg, g, device)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g).to(device)
    print(f"  GPT-2-small ({sum(p.numel() for p in model.parameters())} "
          f"params) initialised in {time.perf_counter() - t0:.1f} s")

    def top2_gap(toks):
        with torch.no_grad():
            logits = transformer_apply(plain, model, toks[:, :P + N - 1])
            top = logits[:, P - 1:].float().topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]

    # the counted run: the f32 pipelined decoder through both kernels
    for k in kernels:
        k.launches = 0
    toks, lps = port.make_pipeline_generate_fn(
        cfg, D, N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"  f32 pipelined decode (D={D}, M={M}, B={B}, P={P}, N={N}): "
          f"kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    check(toks.shape == (B, P + N), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of vocab")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()),
          "log-probs not finite and <= 0")

    toks_p, lps_p = port.make_pipeline_generate_fn(
        plain, D, N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    check(all(k.launches == launches[k.name] for k in kernels),
          "the plain run launched a kernel")
    toks_s, lps_s = port.generate(cfg, model, prompt, N,
                                  return_logprobs=True, device=device)
    res = dict(launches=launches)
    res["kernel_vs_plain"] = compare_tokens(
        "f32 kernel run vs plain run", toks, toks_p, lps, lps_p,
        top2_gap(toks_p))
    res["pipelined_vs_single"] = compare_tokens(
        "f32 pipelined vs single-device generate", toks, toks_s, lps, lps_s,
        top2_gap(toks_s))

    # bf16 compute over the f32 weights: prefill time and decode rate
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    fn1 = port.make_pipeline_generate_fn(cfg16, D, 1, n_streams=M,
                                         return_logprobs=True, device=device)
    fnn = port.make_pipeline_generate_fn(cfg16, D, N, n_streams=M,
                                         return_logprobs=True, device=device)

    def run(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(model, prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run(fn1), run(fnn)  # warm-up
    times1 = [run(fn1)[1] for _ in range(3)]
    # the counted bf16 run: its launches are the kernel line's decode count
    for k in kernels:
        k.launches = 0
    (toks16, lps16), _ = run(fnn)
    launches16 = {k.name: k.launches for k in kernels}
    timesn = [run(fnn)[1] for _ in range(3)]
    check(bool(((toks16 >= 0) & (toks16 < cfg.vocab_size)).all()
               and torch.isfinite(lps16).all()), "bf16 run: bad output")
    t1, tn = min(times1), min(timesn)
    res["bf16"] = dict(prefill_ms=t1 * 1e3, total_ms=tn * 1e3,
                       decode_tokens_per_s=B * (N - 1) / (tn - t1),
                       runs_n1_s=times1, runs_n_s=timesn,
                       launches=launches16,
                       agree_with_f32=float((toks16 == toks).float().mean()))
    for name, n in launches16.items():
        check(n > 0, f"the bf16 run launched {name} no time")
    print(f"  bf16 pipelined decode: prefill (N=1 run) {t1 * 1e3:.1f} ms, "
          f"N={N} run {tn * 1e3:.1f} ms, decode "
          f"{res['bf16']['decode_tokens_per_s']:.1f} tokens/s, launches "
          f"{res['bf16']['launches']}")

    # where the time goes: device kernel time against wall time of one
    # bf16 N-token run, under the profiler (which adds some host time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = run(fnn)
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    res["bf16"]["profile"] = dict(
        wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / (wall * 1e3),
        top_kernels=[dict(name=n[:120], ms=ms, count=c)
                     for n, ms, c in per_kernel[:12]])
    print(f"  bf16 N={N} run under the profiler: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share "
          f"{res['bf16']['profile']['idle_share']:.3f}")
    for n, ms, c in per_kernel[:8]:
        print(f"    {ms:9.3f} ms  {c:6d}x  {n[:100]}")
    report["main_path"] = res
    return launches16


def grad_errors(grads, ref, rtol=1e-4, atol=1e-6):
    """Per-leaf ||g - g_ref|| against the bound rtol ||g_ref|| + atol
    ||G_ref|| (G_ref the global reference gradient): the absolute term
    covers leaves whose true gradient is 0 (the k bias: softmax is
    shift-invariant), where both sides hold rounding noise. Returns the
    worst leaf's ratio to its bound and its name, and the largest relative
    error ||g - g_ref|| / ||g_ref|| over the leaves whose reference norm
    is above 1e-3 ||G_ref||."""
    import torch
    g_norm = torch.sqrt(sum((r.double() ** 2).sum() for r in ref.values()))
    worst, leaf, worst_rel = -1.0, None, 0.0
    for name, r in ref.items():
        r = r.double()
        err = (grads[name].double() - r).norm()
        ratio = (err / (rtol * r.norm() + atol * g_norm)).item()
        if ratio > worst:
            worst, leaf = ratio, name
        if r.norm() > 1e-3 * g_norm:
            worst_rel = max(worst_rel, (err / r.norm()).item())
    return worst, leaf, worst_rel


def phase_train(report, device="cuda"):
    """The training main path (see the module doc); returns the kernel
    launches of the counted bf16 step (the kernels the timed runs take;
    the f32 step's launches are checked, not returned)."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.schedules import (
        analytic_bubble_fraction)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        virtual_stages_for)
    kernels = all_kernels()
    cfg = port.gpt2_config("small", tie_embeddings=True,
                           use_flash_attention=True, use_fused_xent=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    g = torch.Generator().manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=g).to(device)
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                            generator=g).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  tied GPT-2-small ({n_params} params), B={TRAIN_B}, "
          f"S={TRAIN_S}, M={TRAIN_M}")
    res = dict(n_params=n_params)
    sched = port.ScheduleConfig("1F1B", TRAIN_M)
    lps = cfg.n_layers // D

    def one_step(fn):
        """One pipelined (or single-device) forward and backward from zero
        gradients: (loss, gradients, wall seconds)."""
        model.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss = fn(model, tokens, targets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}, wall

    def single_device(m, t, y):
        loss = transformer_loss(cfg, m, t, y)
        loss.backward()
        return loss.detach()

    # (a) the counted run: f32, 1F1B at D = 4, both kernels routed
    fn = port.make_pipeline_grad_fn(cfg, sched, D, device=device)
    one_step(fn)  # warm-up (first launches, allocator)
    for k in kernels:
        k.launches = 0
    loss_k, grads_k, wall_k = one_step(fn)
    launches = {k.name: k.launches for k in kernels}
    # the tick table runs each (stage, microbatch) forward unit once and its
    # backward unit once; under remat the backward unit re-runs the stage
    # forward, and only the last stage's backward unit takes the loss
    want = {"flash_fwd": 2 * TRAIN_M * D * lps, "flash_bwd": TRAIN_M * D * lps,
            "xent_fwd": TRAIN_M, "xent_bwd": TRAIN_M}
    print(f"  f32 1F1B D={D} step (kernels): loss {loss_k:.6f}, "
          f"{wall_k:.2f} s, launches {launches} (table predicts {want})")
    check(launches == want, f"kernel launches {launches} != {want}")
    # (b) the same step on the plain versions; (c) single-device autograd
    # of the whole batch through both kernels
    loss_p, grads_p, _ = one_step(
        port.make_pipeline_grad_fn(plain, sched, D, device=device))
    check(all(k.launches == launches[k.name] for k in kernels),
          "the plain run launched a kernel")
    loss_s, grads_s, _ = one_step(single_device)
    res.update(loss_f32=loss_k, launches=launches, launches_predicted=want,
               f32_step_s=wall_k)
    for name, l_ref, g_ref in (("plain run", loss_p, grads_p),
                               ("single device", loss_s, grads_s)):
        rel = abs(loss_k - l_ref) / abs(l_ref)
        ratio, leaf, worst_rel = grad_errors(grads_k, g_ref)
        print(f"  f32 kernel step vs {name}: loss {l_ref:.6f} (rel err "
              f"{rel:.2e}), worst leaf {leaf} at {ratio:.3f} of its bound, "
              f"max leaf rel err {worst_rel:.2e}")
        check(rel <= 1e-5, f"loss vs {name}: rel err {rel} > 1e-5")
        check(ratio <= 1.0, f"grads vs {name}: leaf {leaf} over its bound "
              f"({ratio})")
        res[f"vs_{name.replace(' ', '_')}"] = dict(
            loss=l_ref, loss_rel_err=rel, worst_bound_ratio=ratio,
            worst_leaf=leaf, max_leaf_rel_err=worst_rel)
    del grads_k, grads_p, grads_s

    # (d) the bf16 gate: the same step in bf16 compute over the f32 master
    # weights (the tokens/s runs' setting), through the kernels, against
    # the plain versions in bf16. bf16 operands round once per product and
    # the two sides sum in other orders, hence the wider bound
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    plain16 = dataclasses.replace(plain, dtype="bfloat16",
                                  param_dtype="float32")
    fn16 = port.make_pipeline_grad_fn(cfg16, sched, D, device=device)
    one_step(fn16)  # warm-up
    for k in kernels:
        k.launches = 0
    loss_k16, grads_k16, wall_k16 = one_step(fn16)
    launches16 = {k.name: k.launches for k in kernels}
    check(launches16 == want,
          f"bf16 step: kernel launches {launches16} != {want}")
    loss_p16, grads_p16, _ = one_step(
        port.make_pipeline_grad_fn(plain16, sched, D, device=device))
    check(all(k.launches == launches16[k.name] for k in kernels),
          "the plain bf16 run launched a kernel")
    rel16 = abs(loss_k16 - loss_p16) / abs(loss_p16)
    ratio16, leaf16, worst_rel16 = grad_errors(grads_k16, grads_p16,
                                               rtol=5e-2, atol=1e-3)
    print(f"  bf16 1F1B D={D} step (kernels) vs plain bf16: loss "
          f"{loss_k16:.6f} vs {loss_p16:.6f} (rel err {rel16:.2e}), worst "
          f"leaf {leaf16} at {ratio16:.3f} of its bound, max leaf rel err "
          f"{worst_rel16:.2e}, launches {launches16}")
    check(rel16 <= 1e-2, f"bf16 loss vs plain: rel err {rel16} > 1e-2")
    check(ratio16 <= 1.0, f"bf16 grads vs plain: leaf {leaf16} over its "
          f"bound ({ratio16})")
    res["bf16_gate"] = dict(
        loss=loss_k16, loss_plain=loss_p16, loss_rel_err=rel16,
        worst_bound_ratio=ratio16, worst_leaf=leaf16,
        max_leaf_rel_err=worst_rel16, launches=launches16, step_s=wall_k16)
    del grads_k16, grads_p16
    model.zero_grad(set_to_none=True)

    # bf16 compute over f32 master weights: make_train_step + adamw
    init_state = {n: p.detach().clone() for n, p in model.state_dict().items()}
    runs = {}
    for name, n_dev in (("GPipe", D), ("1F1B", D), ("Interleaved1F1B", 2)):
        V = virtual_stages_for(name, cfg.n_layers, n_dev)
        model.load_state_dict(init_state)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        opt_state = opt.init(model)
        step = port.make_train_step(cfg16, port.ScheduleConfig(
            name, TRAIN_M, V), n_dev, opt, device=device)
        losses = []

        def counted(m, t, y):
            loss = step(m, opt_state, t, y)
            losses.append(loss)
            return loss

        metrics = port.run_train_iterations(counted, model, tokens, targets,
                                            num_iterations=5,
                                            warmup_iterations=2)
        losses = [x.item() for x in losses]
        bubble = analytic_bubble_fraction(name, n_dev, V, TRAIN_M)
        runs[name] = dict(D=n_dev, V=V, tokens_per_s=metrics["throughput"],
                          elapsed_s=metrics["elapsed_time"],
                          step_s=metrics["elapsed_time"] / 5,
                          bubble=bubble, losses=losses)
        print(f"  bf16 {name} D={n_dev} V={V}: {metrics['throughput']:.1f} "
              f"tokens/s ({metrics['elapsed_time'] / 5 * 1e3:.1f} ms/step), "
              f"analytic bubble {100 * bubble:.1f}%, losses "
              f"{[round(x, 4) for x in losses]}")
        check(all(math.isfinite(x) for x in losses),
              f"{name}: non-finite loss")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall on the "
              f"repeated batch ({losses})")
    res["bf16"] = runs

    # where the time goes: one bf16 1F1B step under the profiler
    from torch.profiler import ProfilerActivity, profile
    model.load_state_dict(init_state)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    opt_state = opt.init(model)
    step = port.make_train_step(cfg16, sched, D, opt, device=device)
    step(model, opt_state, tokens, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(model, opt_state, tokens, targets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    res["profile"] = dict(
        schedule="1F1B", D=D, wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / (wall * 1e3),
        top_kernels=[dict(name=n[:120], ms=ms, count=c)
                     for n, ms, c in per_kernel[:15]])
    print(f"  bf16 1F1B step under the profiler: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share "
          f"{res['profile']['idle_share']:.3f}")
    for n, ms, c in per_kernel[:10]:
        print(f"    {ms:9.3f} ms  {c:6d}x  {n[:100]}")
    report["train"] = res
    return launches16


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import distributed_training_with_pipeline_parallelism_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    t0 = time.perf_counter()
    print("[1] device and toolchain")
    phase_toolchain(report)
    print("[2] kernels against their plain versions")
    main_shapes = phase_kernels(report)
    print("[3] decode path: GPT-2-small, 4 lockstep stages")
    decode_launches = phase_main_path(report)
    print("[4] training path: tied GPT-2-small, pipelined steps")
    launches = phase_train(report)
    report["seconds"] = time.perf_counter() - t0
    out = Path("chip_smoke_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    sources = {"flash_fwd": (
        f"{PKG}/csrc/flash_fwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_attention.py:453 (_flash_fwd_kernel_packed, K4; the same "
        "kernel serves :126 _flash_fwd_kernel, K2)"),
        "xent_fwd": (
        f"{PKG}/csrc/xent_fwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_xent.py:48 (_xent_fwd_kernel, K1)"),
        "flash_bwd": (
        f"{PKG}/csrc/flash_bwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_attention.py:496 (_flash_bwd_kernel_packed, K5; the same "
        "kernel serves :253 _flash_bwd_kernel, K3)"),
        "xent_bwd": (
        f"{PKG}/csrc/xent_bwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_xent.py:92 (_xent_vjp_bwd, the XLA-fused backward of K1)")}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = main_shapes[(name, "bfloat16")]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], dtype=r["dtype"],
            launches_by_path={"train": launches[name],
                              "decode": decode_launches.get(name, 0)}))
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
