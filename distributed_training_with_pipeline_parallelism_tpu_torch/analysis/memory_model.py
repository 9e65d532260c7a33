"""Analytical device-memory model: the bytes-domain twin of
:mod:`.cost_model`.

The port's own copy of the analytic parts of the JAX package's
``analysis/memory_model.py``: ``memory_probe_axes`` (``:58``),
``activation_slot_bytes``, ``params_bytes``, ``stored_residual_bytes``,
``memory_model_section`` (``:202``) with its ``live`` part
(``_live_section``, ``:193``), the serving KV sizing (``kv_page_bytes``
``:306``, ``kv_slot_bytes`` ``:315``, ``size_page_pool`` ``:324``,
``contiguous_slots_for_budget`` ``:335``), ``serving_memory_section``
(``:344``) and ``oom_preflight`` (``:464``). Per device: the peak number
of live
activation and cotangent slots of the tick table times one slot (a
microbatch's ``[mb, seq, dim]`` stage-boundary slab in the compute dtype),
the parameters (layers split over the stages, embedding and head
replicated), the gradients, optimizer moments, and under the stored
backward a first-order estimate of the residuals autograd keeps per
in-flight microbatch. The live slot peaks are the static verifier's
(``table_report``, a ``table_check.TableReport``: ``act_live_peak`` and
``grad_live_peak``; checked afresh when none is given), as in JAX;
shapes come from the port's model on the ``meta`` device.

Differences from the JAX module:

- The JAX ``compiled=`` accounting (``aot_memory_analysis``) is XLA's
  ahead-of-time memory analysis of a compiled step, and its
  ``reconciliation`` holds the analytic argument bytes to it. The port
  runs eagerly and has no compiled program; ``compiled_memory_section``
  and ``reconcile_memory`` are XLA's and not ported (``ROADMAP.md``
  Queue 1, item 9). The measured figures are the card's allocator
  watermarks instead: the ``live`` part, sampled by a stamped
  ``utils.telemetry.PipelineTelemetry`` at the step boundaries
  (``memory_allocated`` and ``max_memory_allocated``; ``available`` is
  False on the CPU), and ``allocator=`` of :func:`memory_model_section`
  and :func:`serving_memory_section` (in the place of JAX's
  ``compiled=``): ``torch.cuda.max_memory_allocated`` over the run after
  ``reset_peak_memory_stats`` (:func:`allocator_stats`), kept as the
  section's ``allocator`` part. :func:`memory_probe_axes` reads its peak
  as the measured side (JAX: XLA's ``temp_bytes``); None on the CPU.
- Under the lockstep transport all D stages share one card. The JAX
  per-device ``peak_bytes`` prices a chip per stage; ``card_bytes`` prices
  the one card: every device's activation and residual bytes, and the
  parameters and gradients of the whole model once.
  :func:`oom_preflight` prices either (``per="device"``, JAX's, or
  ``per="card"``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..parallel.schedules import CompiledSchedule
from .cost_model import (HardwareSpec, detect_hardware, dtype_bytes,
                         model_shapes, resolve_backward_policy)
from .table_check import check_table


def allocator_stats(device) -> Optional[Dict[str, float]]:
    """The card's allocator watermarks since the last
    ``torch.cuda.reset_peak_memory_stats`` (``max_memory_allocated``, and
    ``memory_allocated`` now): the ``allocator=`` of the sections. None
    on the CPU (no allocator statistics)."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return {
        "max_memory_allocated_bytes":
            float(torch.cuda.max_memory_allocated(device)),
        "memory_allocated_bytes": float(torch.cuda.memory_allocated(device)),
    }


def memory_probe_axes(section: Dict[str, Any]
                      ) -> Dict[str, Optional[float]]:
    """The (predicted, measured) peak bytes a calibration ledger row
    records: the analytic per-device peak, and the allocator's
    ``max_memory_allocated`` over the run (the section's ``allocator``
    part; None when it has none, as on the CPU)."""
    analytic = section.get("analytic") or {}
    allocator = section.get("allocator") or {}
    predicted = analytic.get("peak_bytes")
    measured = allocator.get("max_memory_allocated_bytes")
    return {
        "predicted_peak_bytes":
            None if predicted is None else float(predicted),
        "measured_peak_bytes":
            None if measured is None else float(measured),
    }


def activation_slot_bytes(cfg, batch_size: int, seq_length: int,
                          n_microbatches: int) -> int:
    """Bytes of one activation or cotangent slot: one microbatch's
    ``[mb, seq, dim]`` stage-boundary slab in the compute dtype (what one
    ring hop moves)."""
    mb = batch_size // n_microbatches
    return mb * seq_length * cfg.dim * dtype_bytes(cfg.dtype)


def params_bytes(cfg, n_devices: int) -> Dict[str, float]:
    """Per-device parameter bytes: the layer stack split over the stages,
    the embedding and the head replicated on every device."""
    model = model_shapes(cfg)
    nbytes = dtype_bytes(cfg.storage_dtype)
    layer_b = sum(p.numel() for p in model.layers.parameters()) * nbytes
    n_params = sum(p.numel() for p in model.parameters())
    embed_b = n_params * nbytes - layer_b
    return {
        "total_bytes": float(layer_b + embed_b),
        "per_device_bytes": float(layer_b) / n_devices + embed_b,
        "layer_bytes": float(layer_b),
        "replicated_bytes": float(embed_b),
        "n_params": int(n_params),
    }


def stored_residual_bytes(cfg, n_stages: int, tokens_per_mb: float) -> float:
    """First-order residual bytes the stored backward keeps live per
    in-flight microbatch and stage: per layer ``2 dim + ffn_dim`` values a
    token in the compute dtype (an estimate, not an identity)."""
    layers_per_stage = cfg.n_layers / float(n_stages)
    per_layer = tokens_per_mb * (2 * cfg.dim + cfg.ffn_dim)
    return layers_per_stage * per_layer * dtype_bytes(cfg.dtype)


def _live_section(telemetry) -> Optional[Dict[str, Any]]:
    if telemetry is None:
        return None
    summary = getattr(telemetry, "memory_summary", None)
    if summary is None:
        return None
    return summary()


def memory_model_section(cs: CompiledSchedule, cfg, *, batch_size: int,
                         seq_length: int,
                         hardware: Optional[HardwareSpec] = None,
                         remat_backward=None, optimizer_slots: int = 0,
                         table_report=None, telemetry=None,
                         allocator: Optional[Dict[str, float]] = None
                         ) -> Dict[str, Any]:
    """Price one compiled schedule's per-device memory (the JAX section's
    ``analytic`` part, plus ``card_bytes``; see the module doc).
    ``optimizer_slots``: f32 moments per parameter (2 for AdamW, 0 for
    the loss-and-gradients step the sweep times). ``table_report``: the
    table's ``table_check.TableReport`` (checked here when None).
    ``telemetry``: a stamped ``PipelineTelemetry``; its watermark summary
    becomes the ``live`` part. ``allocator``: :func:`allocator_stats`
    over the run, kept as the ``allocator`` part."""
    D = int(cs.table.shape[1])
    hw = hardware if hardware is not None else detect_hardware()
    policy = resolve_backward_policy(cs, remat_backward)
    slot_b = activation_slot_bytes(cfg, batch_size, seq_length,
                                   cs.n_microbatches)
    tokens_per_mb = (batch_size // cs.n_microbatches) * seq_length
    stored_mb_b = (stored_residual_bytes(cfg, cs.n_stages, tokens_per_mb)
                   if policy == "stored" else 0.0)
    pb = params_bytes(cfg, D)
    grads_dev_b = pb["per_device_bytes"]
    opt_dev_b = (optimizer_slots * pb["n_params"] * 4.0 / D
                 if optimizer_slots else 0.0)
    input_b = 2.0 * batch_size * seq_length * 4.0  # tokens and targets

    if table_report is None:
        table_report = check_table(cs)
    act_peaks = table_report.act_live_peak
    grad_peaks = table_report.grad_live_peak
    per_device = []
    for d in range(D):
        act_b = act_peaks[d] * slot_b
        grad_b = grad_peaks[d] * slot_b
        stored_b = act_peaks[d] * stored_mb_b
        total = (act_b + grad_b + stored_b + pb["per_device_bytes"]
                 + grads_dev_b + opt_dev_b)
        per_device.append({
            "device": d,
            "act_live_peak": act_peaks[d],
            "grad_live_peak": grad_peaks[d],
            "act_bytes": int(act_b),
            "grad_bytes": int(grad_b),
            "stored_residual_bytes": float(stored_b),
            "params_bytes": pb["per_device_bytes"],
            "grads_bytes": grads_dev_b,
            "opt_state_bytes": opt_dev_b,
            "total_bytes": float(total),
        })
    peak = max(p["total_bytes"] for p in per_device)
    card = (sum(p["act_bytes"] + p["grad_bytes"] + p["stored_residual_bytes"]
                for p in per_device)
            + 2.0 * pb["total_bytes"] + opt_dev_b * D + input_b)
    analytic: Dict[str, Any] = {
        "act_slot_bytes": int(slot_b),
        "grad_slot_bytes": int(slot_b),
        "stored_residual_bytes_per_mb": float(stored_mb_b),
        "params_total_bytes": pb["total_bytes"],
        "params_per_device_bytes": pb["per_device_bytes"],
        "n_params": pb["n_params"],
        "optimizer_slots": int(optimizer_slots),
        "input_bytes": input_b,
        "activation_peak_bytes": float(
            max(p["act_bytes"] + p["grad_bytes"] for p in per_device)),
        "per_device": per_device,
        "peak_bytes": float(peak),
        "card_bytes": float(card),
    }
    if hw.hbm_bytes:
        analytic["hbm_frac"] = peak / hw.hbm_bytes
    section: Dict[str, Any] = {
        "schedule": cs.name,
        "n_devices": D,
        "n_virtual": int(cs.n_virtual),
        "n_microbatches": int(cs.n_microbatches),
        "batch_size": int(batch_size),
        "seq_length": int(seq_length),
        "dtype": str(cfg.dtype),
        "param_dtype": str(cfg.storage_dtype),
        "backward_policy": policy,
        "hardware": hw.summary(),
        "analytic": analytic,
    }
    if allocator is not None:
        section["allocator"] = dict(allocator)
    live = _live_section(telemetry)
    if live is not None:
        section["live"] = live
    return section


def kv_page_bytes(cfg, *, n_devices: int, page_size: int) -> float:
    """Bytes of one K+V page pair per device (the paged pool's unit):
    ``2 x layers/D x page_size x n_kv x head_dim x dtype``."""
    lps = cfg.n_layers // n_devices
    n_kv = cfg.n_kv_heads or cfg.n_heads
    return (2.0 * lps * page_size * n_kv * cfg.head_dim
            * dtype_bytes(cfg.dtype))


def kv_slot_bytes(cfg, *, n_devices: int, mlen_alloc: int) -> float:
    """Bytes of one contiguous slot's K+V cache per device: what every
    slot reserves up front without paging."""
    lps = cfg.n_layers // n_devices
    n_kv = cfg.n_kv_heads or cfg.n_heads
    return (2.0 * lps * mlen_alloc * n_kv * cfg.head_dim
            * dtype_bytes(cfg.dtype))


def size_page_pool(cfg, *, n_devices: int, page_size: int,
                   budget_bytes: float) -> int:
    """The most pages (the null page 0 included) whose per-device pool
    fits ``budget_bytes``; 0 when fewer than two fit (a pool needs the
    null page and one usable page)."""
    pg_b = kv_page_bytes(cfg, n_devices=n_devices, page_size=page_size)
    n = int(budget_bytes // pg_b)
    return n if n >= 2 else 0


def contiguous_slots_for_budget(cfg, *, n_devices: int, mlen_alloc: int,
                                budget_bytes: float) -> int:
    """How many worst-case contiguous slots the same budget buys (the
    matched-budget twin of :func:`size_page_pool`)."""
    slot_b = kv_slot_bytes(cfg, n_devices=n_devices, mlen_alloc=mlen_alloc)
    return int(budget_bytes // slot_b)


def serving_memory_section(cfg, program, *,
                           hardware: Optional[HardwareSpec] = None,
                           allocator: Optional[Dict[str, float]] = None,
                           prefix_stats: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, Any]:
    """The memory section of a serving run (the training section's
    schema). The activation state is one ``[1, C, dim]`` slab a device,
    priced as one ``act`` slot of C tokens. The KV cache dominates:
    contiguous, ``2 x layers/D x n_slots x mlen_alloc x n_kv_heads x
    head_dim`` a device; paged (``program.paged``), the pool of
    ``n_pages x page_size`` rows and the page table, from the expressions
    the program allocates with (JAX prices an int32 table and its
    copy-on-write pair, as here; the port's table is int64 on the card).

    ``prefix_stats`` (paged; ``{"hit_rate": h, "mean_prompt_len": p,
    "mean_budget": b}``) adds the expected demand discount of prefix
    sharing: a request's page demand shrinks by ``h * p / (p + b)``, so
    the same pool admits proportionally more requests. ``allocator``:
    :func:`allocator_stats` over the run (JAX's ``compiled=``, see the
    module doc), kept as the ``allocator`` part."""
    hw = hardware if hardware is not None else detect_hardware()
    D = int(program.n_stages)
    M = int(program.n_slots)
    C = int(program.prefill_chunk)
    lps = cfg.n_layers // D
    n_kv = cfg.n_kv_heads or cfg.n_heads
    dt_b = dtype_bytes(cfg.dtype)
    paged = bool(getattr(program, "paged", False))
    paged_info: Optional[Dict[str, Any]] = None
    if paged:
        pg_b = kv_page_bytes(cfg, n_devices=D, page_size=program.page_size)
        kv_dev_b = program.n_pages * pg_b
        # the int32 table and its copy-on-write pair, on every device
        tbl_b = 4.0 * M * (program.max_pages_per_slot + 2)
        kv_dev_b += tbl_b
        paged_info = {
            "page_size": int(program.page_size),
            "n_pages": int(program.n_pages),
            "max_pages_per_slot": int(program.max_pages_per_slot),
            "page_bytes_per_device": float(pg_b),
            "pool_bytes_per_device": float(program.n_pages * pg_b),
            "page_table_bytes_per_device": float(tbl_b),
            # what the same bytes would buy as contiguous slots
            "contiguous_slot_bytes": float(kv_slot_bytes(
                cfg, n_devices=D, mlen_alloc=program.mlen_alloc)),
        }
        if prefix_stats:
            h = float(prefix_stats.get("hit_rate", 0.0))
            p_len = float(prefix_stats.get("mean_prompt_len", 0.0))
            b_len = float(prefix_stats.get("mean_budget", 0.0))
            disc = (h * p_len / (p_len + b_len)
                    if (p_len + b_len) > 0 else 0.0)
            paged_info["expected_sharing_discount"] = round(disc, 6)
            paged_info["effective_capacity_factor"] = (
                round(1.0 / (1.0 - disc), 6) if disc < 1.0 else None)
    else:
        kv_dev_b = (2.0 * lps * M * program.mlen_alloc * n_kv
                    * cfg.head_dim * dt_b)
    slot_b = C * cfg.dim * dt_b
    pb = params_bytes(cfg, D)
    per_device = []
    for d in range(D):
        total = slot_b + kv_dev_b + pb["per_device_bytes"]
        per_device.append({
            "device": d, "act_live_peak": 1, "grad_live_peak": 0,
            "act_bytes": int(slot_b), "grad_bytes": 0,
            "kv_cache_bytes": float(kv_dev_b),
            "params_bytes": pb["per_device_bytes"],
            "opt_state_bytes": 0.0,
            "total_bytes": float(total),
        })
    peak = max(pd["total_bytes"] for pd in per_device)
    analytic: Dict[str, Any] = {
        "act_slot_bytes": int(slot_b),
        "grad_slot_bytes": 0,
        "kv_cache_bytes_per_device": float(kv_dev_b),
        "params_total_bytes": pb["total_bytes"],
        "params_per_device_bytes": pb["per_device_bytes"],
        "n_params": pb["n_params"],
        "optimizer_slots": 0,
        # the state a serving step takes: the per-device KV dominates it
        "input_bytes": float(kv_dev_b),
        "activation_peak_bytes": float(slot_b),
        "per_device": per_device,
        "peak_bytes": float(peak),
    }
    if hw.hbm_bytes:
        analytic["hbm_frac"] = peak / hw.hbm_bytes
    if paged_info is not None:
        analytic["paged"] = paged_info
    section: Dict[str, Any] = {
        "schedule": "serving_ring",
        "n_devices": D,
        "n_virtual": 1,
        "n_microbatches": M,
        "batch_size": M,
        "seq_length": int(program.max_len),
        "dtype": str(cfg.dtype),
        "param_dtype": str(cfg.storage_dtype),
        "backward_policy": "none",
        "hardware": hw.summary(),
        "analytic": analytic,
    }
    if allocator is not None:
        section["allocator"] = dict(allocator)
    return section


def oom_preflight(section: Dict[str, Any],
                  hardware: Optional[HardwareSpec] = None,
                  headroom: float = 1.0, per: str = "device"
                  ) -> Dict[str, Any]:
    """Price a memory section against the capacity: ``ok=False`` when the
    analytic bytes exceed ``headroom x hbm_bytes`` (unknown capacity, 0,
    always passes). ``per="device"`` prices the per-device peak (the JAX
    preflight: a chip per stage); ``per="card"`` the one card the lockstep
    transport runs every stage on."""
    key = {"device": "peak_bytes", "card": "card_bytes"}[per]
    hw = hardware if hardware is not None else detect_hardware()
    peak = float(section["analytic"][key])
    cap = float(hw.hbm_bytes) * headroom
    return {
        "ok": bool(cap <= 0 or peak <= cap),
        "predicted_peak_bytes": peak,
        "hbm_bytes": float(hw.hbm_bytes),
        "headroom": float(headroom),
        "hbm_frac": peak / cap if cap > 0 else None,
    }
