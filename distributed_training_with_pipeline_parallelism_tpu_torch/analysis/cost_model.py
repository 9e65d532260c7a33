"""Analytical cost model: roofline prices of a compiled tick table.

The port's own copy of the numpy parts of the JAX package's
``analysis/cost_model.py``: ``HardwareSpec`` (``:74``), ``dtype_bytes``,
``fwd_flops_per_token`` (``:156``), ``train_flops_per_token``,
``resolve_backward_policy`` (``:187``), ``backward_weights`` (``:204``),
``predicted_step_time`` (``:230``), ``comm_overlap_step_time`` (``:259``)
and ``predicted_tick_seconds`` (``:329``) with their calibration
correction, ``cost_model_section`` (``:376``) with its correction and its
measured attribution from a stamped ``utils.telemetry.PipelineTelemetry``,
and the serving section (``expected_tokens_per_verify`` ``:553``,
``serving_cost_model_section`` ``:572``).
Each F unit is priced at one microbatch's forward FLOPs through one stage,
B and W (and their recomputes under remat and the split backward) in
forward-unit equivalents, each ring
hop at one stage-boundary slab over the link bandwidth; the lockstep tick
lasts as long as its slowest device. A correction
(``analysis.calibration.CorrectionFactors``, or the per-hardware mapping
``calibration.load_correction_artifact`` returns) de-rates the roofline:
unit seconds over its ``flops_efficiency``, hop seconds over its
``bandwidth_efficiency``.

Differences from the JAX module:

- The parameter count comes from the port's model built on the ``meta``
  device (no memory), not from ``jax.eval_shape``.
- Hardware: :data:`H100` (989e12 FLOP/s dense bf16, 3.35e12 B/s of HBM,
  the capacity ``torch.cuda.get_device_properties(0).total_memory``
  reports). Under the port's lockstep transport every stage runs on the
  one card and a ring hop is a copy inside its HBM, so the link bandwidth
  is the HBM figure. An unknown CUDA card raises instead of falling back
  to a TPU preset; ``cpu`` maps to the labelled :data:`CPU_PROXY`, as in
  JAX. No TPU figure is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..parallel.schedules import (BANK_BEFORE_F, CHANNELS, CompiledSchedule,
                                  analytic_bubble_fraction,
                                  overlap_bank_stages, table_unit_activity)
from .table_check import check_table, hops_per_tick

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline parameters of one chip: ``peak_flops`` (dense bf16),
    ``ici_bytes_per_s`` (the link one ring hop crosses),
    ``hbm_bytes_per_s`` and ``hbm_bytes`` (capacity; 0 = unknown, the OOM
    preflight then passes). ``cpu_proxy``: order-of-magnitude placeholders
    for a CPU host, not a device's figures."""

    name: str
    peak_flops: float
    ici_bytes_per_s: float
    hbm_bytes_per_s: float
    hbm_bytes: float = 0.0
    cpu_proxy: bool = False

    def summary(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# NVIDIA's data sheet, H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.
# A ring hop of the lockstep transport is an HBM-to-HBM copy on the card.
H100 = HardwareSpec("h100", 989e12, 3.35e12, 3.35e12)

# the JAX package's CPU stand-in: honest only about orders of magnitude
CPU_PROXY = HardwareSpec("cpu_proxy", 5e10, 1e9, 5e10, 16e9, cpu_proxy=True)


def hardware_spec_for(device_kind: str, hbm_bytes: float = 0.0
                      ) -> HardwareSpec:
    """The preset of a ``device_kind``: an H100 (``"NVIDIA H100 80GB
    HBM3"``) -> :data:`H100` with capacity ``hbm_bytes``; anything CPU-ish
    or empty -> :data:`CPU_PROXY`; any other card raises."""
    kind = (device_kind or "").lower()
    if "h100" in kind:
        return dataclasses.replace(H100, hbm_bytes=float(hbm_bytes))
    if "cpu" in kind or kind == "":
        return CPU_PROXY
    raise ValueError(f"no roofline preset for {device_kind!r}: the port "
                     f"has one for the H100")


def detect_hardware(device="cuda") -> HardwareSpec:
    """The spec of ``device``: the CUDA card's preset with its capacity,
    :data:`CPU_PROXY` for the CPU."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_PROXY
    props = torch.cuda.get_device_properties(device)
    return hardware_spec_for(props.name, props.total_memory)


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 4)


def model_shapes(cfg):
    """The port's model for ``cfg`` on the ``meta`` device: parameter
    shapes and dtypes with no memory behind them."""
    from ..models.transformer import Transformer
    from ..utils.config import torch_dtype
    return Transformer(cfg, device="meta",
                       dtype=torch_dtype(cfg.storage_dtype))


def fwd_flops_per_token(cfg, seq: int) -> float:
    """Forward FLOPs per token: ``2N`` over the parameters that take part
    in a matmul (the token table only when tied; no positions), plus
    attention's ``4 L dim seq``, halved when causal and doubled for the
    reference block's two unmasked attentions."""
    model = model_shapes(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    if not cfg.tie_embeddings:
        n_params -= model.tok.numel()  # lookup only, no matmul
    if cfg.arch == "gpt2":
        n_params -= model.pos.numel()  # additive lookup
    attn_fwd_per_tok = 2 * 2 * cfg.n_layers * cfg.dim * seq
    attn_fwd_per_tok *= 2 if cfg.arch == "ref_decoder" else 0.5
    return 2.0 * n_params + attn_fwd_per_tok


def train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token: forward and twice it backward."""
    return 3.0 * fwd_flops_per_token(cfg, seq)


def resolve_backward_policy(cs: CompiledSchedule, remat_backward=None,
                            n_devices: Optional[int] = None) -> str:
    """The backward ``make_pipeline_grad_fn`` runs: 'split' for a
    split-backward table (B: recompute + dgrad, W: recompute + wgrad),
    else 'stored' at D == 1 by default or with ``remat_backward=False``,
    else 'remat'."""
    if cs.split_backward:
        return "split"
    D = cs.n_devices if n_devices is None else n_devices
    stored = remat_backward is False or (remat_backward is None and D == 1)
    return "stored" if stored else "remat"


def backward_weights(policy: str) -> Tuple[float, float]:
    """(B, W) unit cost in forward units: stored B = dgrad + wgrad ~ 2F
    and no W unit (weight 1, as in JAX); remat adds the 1F recompute;
    split B = recompute + dgrad ~ 2F, W = recompute + wgrad ~ 2F."""
    return {"stored": (2.0, 1.0), "remat": (3.0, 1.0),
            "split": (2.0, 2.0)}[policy]


def predicted_step_time(table: np.ndarray, unit_s: Tuple[float, float, float],
                        hop_s: float, hops_total: int) -> Dict[str, float]:
    """The lockstep time model: each tick lasts its slowest device's units
    (``unit_s`` = F, B, W seconds), ring hops serialized after compute
    (``step_s``) or overlapped with their launching tick
    (``step_s_overlapped``)."""
    activity = table_unit_activity(table)          # [T, D, (F,B,W,idle)]
    vec = np.array([unit_s[0], unit_s[1], unit_s[2], 0.0], dtype=np.float64)
    compute_tick_s = (activity.astype(np.float64) @ vec).max(axis=1)
    t_compute_s = float(compute_tick_s.sum())
    t_comm_s = float(hops_total) * hop_s
    idle_cells = int(activity[:, :, 3].sum())
    T, D = int(table.shape[0]), int(table.shape[1])
    return {
        "compute_s": t_compute_s,
        "comm_s": t_comm_s,
        "step_s": t_compute_s + t_comm_s,
        "step_s_overlapped": float(np.maximum(
            compute_tick_s, hops_per_tick(table) * hop_s).sum()),
        "bubble_table_exact": idle_cells / float(T * D),
    }


def _derated(unit_s, hop_s, correction):
    """``unit_s`` and ``hop_s`` over a correction's efficiencies (as
    given when ``correction`` is None)."""
    if correction is None:
        return unit_s, hop_s
    e_f = float(correction.flops_efficiency)
    e_b = float(correction.bandwidth_efficiency)
    return (unit_s[0] / e_f, unit_s[1] / e_f, unit_s[2] / e_f), hop_s / e_b


def _comm_overlap_ticks(table: np.ndarray,
                        unit_s: Tuple[float, float, float], hop_s: float,
                        bank_stages: Optional[np.ndarray]):
    """Per tick: the compute seconds and the hops landing there that are
    exposed and overlappable under the double-buffered ring."""
    table = np.asarray(table)
    if bank_stages is None:
        bank_stages = overlap_bank_stages(table)
    activity = table_unit_activity(table)
    vec = np.array([unit_s[0], unit_s[1], unit_s[2], 0.0], dtype=np.float64)
    compute_tick_s = (activity.astype(np.float64) @ vec).max(axis=1)  # [T]
    T = table.shape[0]
    exposed = np.zeros(T, dtype=np.int64)
    deferred = np.zeros(T, dtype=np.int64)
    for u in range(1, T):
        for ci, (_, _, col) in enumerate(CHANNELS):
            if (table[u, :, col] >= 0).any():
                if bank_stages[u, ci] == BANK_BEFORE_F:
                    exposed[u] += 1
                else:
                    deferred[u] += 1
    return compute_tick_s, exposed, deferred


def comm_overlap_step_time(table: np.ndarray,
                           unit_s: Tuple[float, float, float],
                           hop_s: float,
                           bank_stages: Optional[np.ndarray] = None,
                           correction=None) -> Dict[str, float]:
    """The step time under the double-buffered ring
    (``make_pipeline_grad_fn(comm_overlap="ring")``): a hop that lands at
    tick u and banks before its first unit (stage 0 of
    ``schedules.overlap_bank_stages``) is exposed, serialized as in the
    lockstep; one banked later overlaps the tick's earlier units, so

        time_u = exposed_hops_u * hop_s
                 + max(compute_u, overlappable_hops_u * hop_s)

    which lies between ``step_s_overlapped`` and ``step_s`` summed over
    the ticks. ``correction`` de-rates ``unit_s`` and ``hop_s`` first (see
    the module doc); both scalings are positive, so the envelope's order
    holds."""
    unit_s, hop_s = _derated(unit_s, hop_s, correction)
    compute_tick_s, exposed, deferred = _comm_overlap_ticks(
        table, unit_s, hop_s, bank_stages)
    tick_s = exposed * hop_s + np.maximum(compute_tick_s, deferred * hop_s)
    return {
        "step_s_comm_overlap": float(tick_s.sum()),
        "exposed_hops": int(exposed.sum()),
        "overlappable_hops": int(deferred.sum()),
        "exposed_comm_s": float(exposed.sum() * hop_s),
        "hidden_comm_s": float(
            (np.minimum(deferred * hop_s, compute_tick_s)).sum()),
    }


def predicted_tick_seconds(table: np.ndarray,
                           unit_s: Tuple[float, float, float],
                           hop_s: float,
                           bank_stages: Optional[np.ndarray] = None,
                           correction=None) -> np.ndarray:
    """``[T]`` predicted seconds per tick under the attribution of
    :func:`comm_overlap_step_time` (they sum to its
    ``step_s_comm_overlap``): what ``utils.telemetry.perfetto_trace``
    lays beside each measured tick."""
    unit_s, hop_s = _derated(unit_s, hop_s, correction)
    compute_tick_s, exposed, deferred = _comm_overlap_ticks(
        table, unit_s, hop_s, bank_stages)
    return exposed * hop_s + np.maximum(compute_tick_s, deferred * hop_s)


def _resolve_correction(correction, hw_name: str):
    """A ``CorrectionFactors`` as given, a ``{hardware name: factors}``
    mapping's entry for ``hw_name``, or None."""
    if correction is None:
        return None
    if hasattr(correction, "flops_efficiency"):
        return correction
    if hasattr(correction, "get"):
        return correction.get(hw_name)
    return None


def cost_model_section(cs: CompiledSchedule, cfg, *, batch_size: int,
                       seq_length: int,
                       hardware: Optional[HardwareSpec] = None,
                       remat_backward=None,
                       measured_step_s: Optional[float] = None,
                       telemetry=None, table_report=None,
                       comm_overlap: str = "none",
                       correction=None) -> Dict[str, Any]:
    """Price one compiled schedule on ``hardware`` (default: the CUDA
    card) and, given ``measured_step_s``, reconcile it: the JAX section's
    keys. ``mfu`` divides by D chips as in JAX; under the lockstep
    transport the D stages share one card, whose own utilization is
    ``D * mfu``. ``comm_overlap`` records the run's ring discipline
    ("none" or "ring"); ``step_s_comm_overlap`` prices the table either
    way.

    ``telemetry``: a stamped ``utils.telemetry.PipelineTelemetry`` over
    this table. It supplies ``measured_step_s`` (the sum of its timeline's
    durations) when none is given, adds the critical-path ``attribution``
    (compute, comm and bubble seconds, the straggler device) and
    ``measured.bubble_measured_mean``. ``correction``: fitted efficiencies
    (see the module doc); when one matches ``hardware``'s name,
    ``predicted.corrected`` re-prices every step time under the de-rated
    roofline and ``measured.rel_err_corrected`` sits beside ``rel_err``."""
    table = cs.table
    T, D = int(table.shape[0]), int(table.shape[1])
    hw = hardware if hardware is not None else detect_hardware()
    policy = resolve_backward_policy(cs, remat_backward)
    w_b, w_w = backward_weights(policy)

    fwd_tok = fwd_flops_per_token(cfg, seq_length)
    tokens_per_step = float(batch_size) * float(seq_length)
    tokens_per_mb = tokens_per_step / cs.n_microbatches
    unit_f = fwd_tok * tokens_per_mb / cs.n_stages
    unit_b, unit_w = w_b * unit_f, w_w * unit_f
    model_per_step = 3.0 * fwd_tok * tokens_per_step
    counts = table_unit_activity(table).sum(axis=(0, 1))
    hardware_per_step = (float(counts[0]) * unit_f
                         + float(counts[1]) * unit_b
                         + float(counts[2]) * unit_w)

    bytes_per_hop = tokens_per_mb * cfg.dim * dtype_bytes(cfg.dtype)
    if table_report is None:
        table_report = check_table(cs)
    hops_total = int(table_report.predicted_ppermutes)
    hop_s = bytes_per_hop / hw.ici_bytes_per_s
    unit_sec = (unit_f / hw.peak_flops, unit_b / hw.peak_flops,
                unit_w / hw.peak_flops)
    tm = predicted_step_time(table, unit_sec, hop_s, hops_total)
    ov = comm_overlap_step_time(table, unit_sec, hop_s)
    t_compute_s = tm["compute_s"]
    ideal_compute_s = hardware_per_step / (D * hw.peak_flops)

    section: Dict[str, Any] = {
        "schedule": cs.name,
        "n_devices": D,
        "n_virtual": int(cs.n_virtual),
        "n_microbatches": int(cs.n_microbatches),
        "n_ticks": T,
        "batch_size": int(batch_size),
        "seq_length": int(seq_length),
        "backward_policy": policy,
        "comm_overlap": comm_overlap,
        "hardware": hw.summary(),
        "flops": {
            "fwd_per_token": fwd_tok,
            "train_per_token": 3.0 * fwd_tok,
            "unit": {"F": unit_f, "B": unit_b, "W": unit_w},
            "model_per_step": model_per_step,
            "hardware_per_step": hardware_per_step,
        },
        "comm": {
            "bytes_per_hop": float(bytes_per_hop),
            "hops": hops_total,
            "bytes_total": float(bytes_per_hop) * hops_total,
            "exposed_hops": ov["exposed_hops"],
            "overlappable_hops": ov["overlappable_hops"],
        },
        "predicted": {
            "compute_s": t_compute_s,
            "comm_s": tm["comm_s"],
            "step_s": tm["step_s"],
            "step_s_overlapped": tm["step_s_overlapped"],
            "step_s_comm_overlap": ov["step_s_comm_overlap"],
            "exposed_comm_s": ov["exposed_comm_s"],
            "hidden_comm_s": ov["hidden_comm_s"],
            "ideal_compute_s": ideal_compute_s,
            "bubble_table_exact": tm["bubble_table_exact"],
            "bubble_weighted": (1.0 - ideal_compute_s / t_compute_s
                                if t_compute_s > 0 else 0.0),
            "bubble_closed_form": float(analytic_bubble_fraction(
                cs.name, D, cs.n_virtual, cs.n_microbatches, cs=cs)),
        },
    }
    corr = _resolve_correction(correction, hw.name)
    if corr is not None:
        # every variant re-priced under the de-rated roofline
        tm_c = predicted_step_time(table, *_derated(unit_sec, hop_s, corr),
                                   hops_total)
        ov_c = comm_overlap_step_time(table, unit_sec, hop_s,
                                      correction=corr)
        section["predicted"]["corrected"] = {
            "flops_efficiency": float(corr.flops_efficiency),
            "bandwidth_efficiency": float(corr.bandwidth_efficiency),
            "compute_s": tm_c["compute_s"],
            "comm_s": tm_c["comm_s"],
            "step_s": tm_c["step_s"],
            "step_s_overlapped": tm_c["step_s_overlapped"],
            "step_s_comm_overlap": ov_c["step_s_comm_overlap"],
        }
    stamped = telemetry is not None and bool(telemetry.events)
    if stamped:
        if measured_step_s is None:
            measured_step_s = sum((rec.get("duration_s") or 0.0)
                                  for rec in telemetry.timeline())
        from ..utils.telemetry import critical_path
        cp = critical_path(telemetry)
        section["attribution"] = {
            k: cp[k] for k in ("compute_s", "comm_s", "bubble_s", "total_s",
                               "n_ticks", "straggler_device",
                               "straggler_stage", "straggler_s_per_device")}
    if measured_step_s is not None and measured_step_s > 0:
        chip_s = measured_step_s * D * hw.peak_flops
        measured: Dict[str, Any] = {
            "step_s": float(measured_step_s),
            "tokens_per_sec": tokens_per_step / measured_step_s,
            "mfu": model_per_step / chip_s,
            "hfu": hardware_per_step / chip_s,
            "predicted_over_measured": tm["step_s"] / measured_step_s,
            # signed: negative = the roofline is optimistic
            "rel_err": (tm["step_s"] - measured_step_s) / measured_step_s,
        }
        corrected = section["predicted"].get("corrected")
        if corrected is not None:
            measured["rel_err_corrected"] = \
                (corrected["step_s"] - measured_step_s) / measured_step_s
        if stamped:
            sb = telemetry.stage_breakdown()
            measured["bubble_measured_mean"] = sb["bubble_measured_mean"]
        section["measured"] = measured
    return section


def expected_tokens_per_verify(alpha: float, gamma: int) -> float:
    """Expected tokens a verify visit emits under greedy speculative
    decoding with per-position acceptance rate ``alpha`` and draft length
    ``gamma`` (Leviathan et al., arXiv:2211.17192):
    ``(1 - alpha^(gamma+1)) / (1 - alpha)``; ``gamma + 1`` at
    ``alpha = 1`` and 1 at ``alpha = 0``."""
    g = int(gamma)
    if g < 0:
        raise ValueError(f"gamma must be >= 0, got {gamma}")
    a = min(max(float(alpha), 0.0), 1.0)
    if a >= 1.0:
        return float(g + 1)
    return (1.0 - a ** (g + 1)) / (1.0 - a)


def serving_cost_model_section(cfg, n_pipe: int, n_slots: int,
                               summary: Dict[str, Any],
                               hardware: Optional[HardwareSpec] = None,
                               draft_cfg=None, correction=None
                               ) -> Dict[str, Any]:
    """The cost-model section of a serving run (the training section's
    schema). A decode tick moves one token-slot through each stage and
    rolls the ring once: predicted per-tick time is the roofline of one
    token's stage slice plus one hop of a ``dim``-wide row; measured MFU
    counts forward FLOPs only. ``summary``: a
    ``utils.telemetry.serving_summary`` dict (ticks, wall_s,
    tokens_out, ...).

    With the speculative gauges in ``summary`` (``speculative``,
    ``gamma``, ``acceptance_rate``) a ``speculative`` subsection prices
    the draft-verify tick: the target's verify FLOPs over ``gamma + 1``
    rows, the draft's (``draft_cfg``; stage 0 runs it for every slot, so
    not divided over the stages) for ``gamma`` proposals, the expected
    tokens a tick from the measured acceptance rate, and the predicted
    shift of the saturation knee; ``correction`` (as in
    :func:`cost_model_section`) adds its de-rated twin."""
    hw = hardware if hardware is not None else detect_hardware()
    seq = cfg.max_seq_len
    fwd_tok = fwd_flops_per_token(cfg, seq)
    bytes_per_hop = float(cfg.dim * dtype_bytes(cfg.dtype))
    per_tick_compute_s = fwd_tok / n_pipe / hw.peak_flops
    hop_s = bytes_per_hop / hw.ici_bytes_per_s
    ticks = int(summary.get("ticks") or 0)
    wall_s = float(summary.get("wall_s") or 0.0)
    tokens_out = int(summary.get("tokens_out") or 0)
    section: Dict[str, Any] = {
        "schedule": "serving_ring",
        "n_devices": int(n_pipe),
        "n_virtual": 1,
        "n_microbatches": int(n_slots),
        "n_ticks": ticks,
        "batch_size": int(n_slots),
        "seq_length": int(seq),
        "backward_policy": "none",
        "hardware": hw.summary(),
        "flops": {
            "fwd_per_token": fwd_tok,
            "train_per_token": 0.0,
            "unit": {"F": fwd_tok / n_pipe, "B": 0.0, "W": 0.0},
            "model_per_step": fwd_tok,        # per decoded token
            "hardware_per_step": fwd_tok,
        },
        "comm": {
            "bytes_per_hop": bytes_per_hop,
            # the ring rolls every tick whatever the slots hold
            "hops": ticks,
            "bytes_total": bytes_per_hop * ticks,
        },
        "predicted": {
            "compute_s": per_tick_compute_s,
            "comm_s": hop_s,
            "step_s": per_tick_compute_s + hop_s,   # per tick
            "step_s_overlapped": max(per_tick_compute_s, hop_s),
            # the serving ring banks its arrival at the tick's top, so
            # its comm_overlap price is the serial one
            "step_s_comm_overlap": per_tick_compute_s + hop_s,
            "ideal_compute_s": per_tick_compute_s,
            "bubble_table_exact": 0.0,
            "bubble_weighted": 0.0,
            "bubble_closed_form": 0.0,
        },
    }
    if ticks > 0 and wall_s > 0:
        chip_s = wall_s * n_pipe * hw.peak_flops
        section["measured"] = {
            "step_s": wall_s / ticks,                # per tick
            "tokens_per_sec": tokens_out / wall_s,
            "mfu": tokens_out * fwd_tok / chip_s,
            "hfu": tokens_out * fwd_tok / chip_s,
            "predicted_over_measured":
                section["predicted"]["step_s"] / (wall_s / ticks),
        }

    if summary.get("speculative"):
        gamma = int(summary.get("gamma") or 0)
        alpha = summary.get("acceptance_rate")
        exp_tok = expected_tokens_per_verify(
            alpha if alpha is not None else 0.0, gamma)
        draft_tok = (fwd_flops_per_token(draft_cfg, seq)
                     if draft_cfg is not None else 0.0)
        verify_s = (gamma + 1) * fwd_tok / n_pipe / hw.peak_flops
        draft_s = gamma * draft_tok / hw.peak_flops
        base_tick_s = per_tick_compute_s + hop_s
        spec_tick_s = verify_s + draft_s + hop_s
        # tokens/s scale: the tokens a tick gains over the tick's cost;
        # capacity at saturation is tokens/s-bound, so the knee moves by
        # the same factor
        knee_scale = (exp_tok / (spec_tick_s / base_tick_s)
                      if base_tick_s > 0 else None)
        spec: Dict[str, Any] = {
            "gamma": gamma,
            "acceptance_rate": alpha,
            "expected_tokens_per_tick": exp_tok,
            "draft_flops_per_token": draft_tok,
            "flops_per_tick": {
                "verify": (gamma + 1) * fwd_tok,
                "draft": gamma * draft_tok,
            },
            "predicted": {
                "tick_s": spec_tick_s,
                "s_per_token": spec_tick_s / exp_tok,
                "baseline_s_per_token": base_tick_s,
                "tokens_per_sec_scale": knee_scale,
                "knee_scale": knee_scale,
            },
        }
        corr = _resolve_correction(correction, hw.name)
        if corr is not None:
            e_f = float(corr.flops_efficiency)
            e_b = float(corr.bandwidth_efficiency)
            c_base = per_tick_compute_s / e_f + hop_s / e_b
            c_tick = (verify_s + draft_s) / e_f + hop_s / e_b
            spec["predicted"]["corrected"] = {
                "tick_s": c_tick,
                "s_per_token": c_tick / exp_tok,
                "knee_scale": (exp_tok / (c_tick / c_base)
                               if c_base > 0 else None),
            }
        section["speculative"] = spec
    return section
