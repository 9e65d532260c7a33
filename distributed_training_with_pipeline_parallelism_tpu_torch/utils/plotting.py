"""The reference notebook's sweep figures (the port's own copy of the JAX
package's ``utils/plotting.py``): speedup and scaling efficiency by model
configuration, throughput against devices per (layers, heads), the
per-device timeline of a compiled tick table, that timeline over the
measured tick cost of a ``PipelineTelemetry`` timeline, and serving's
latency-against-load curve and queue depth. pandas and matplotlib are
imported inside the functions (the H100 host has neither; the sweep's CSV
and the run reports are plotted where they are installed)."""

from __future__ import annotations

from typing import Optional

SCHEDULE_COLORS = {"GPipe": "tab:blue", "1F1B": "tab:orange",
                   "Interleaved1F1B": "tab:green", "BFS": "tab:purple"}
PROC_MARKERS = {2: "o", 4: "s", 8: "^", 16: "D"}
OP_COLORS = {"F": "#4e9ad1", "B": "#f29d4b", "W": "#8ec07c"}


def _mpl():
    import matplotlib
    # headless, but a notebook's inline backend is left alone
    if "inline" not in matplotlib.get_backend().lower():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _frame(rows):
    import pandas as pd
    return rows if isinstance(rows, pd.DataFrame) else pd.DataFrame(
        list(rows))


def plot_speedup_and_efficiency(speedup, path: Optional[str] = None):
    """Speedup and scaling efficiency against ``L{n}_H{h}``, coloured by
    schedule, marked by device count, with the GPipe lines (cell 28).
    ``speedup``: rows of ``compute_speedup_and_efficiency`` or a
    DataFrame of them."""
    speedup_df = _frame(speedup)
    plt = _mpl()
    fig, (ax_s, ax_e) = plt.subplots(1, 2, figsize=(14, 5))
    configs = sorted({(r.n_layers, r.n_heads)
                      for r in speedup_df.itertuples()})
    labels = [f"L{L}_H{H}" for L, H in configs]
    xs = range(len(configs))
    for schedule, g1 in speedup_df.groupby("schedule"):
        for procs, g2 in g1.groupby("num_processes"):
            lookup = {(r.n_layers, r.n_heads): r for r in g2.itertuples()}
            ys_s = [lookup[c].speedup if c in lookup else None
                    for c in configs]
            ys_e = [lookup[c].efficiency if c in lookup else None
                    for c in configs]
            style = dict(color=SCHEDULE_COLORS.get(schedule),
                         marker=PROC_MARKERS.get(procs, "x"),
                         label=f"{schedule} ({procs} devices)")
            ax_s.plot(xs, ys_s, **style)
            ax_e.plot(xs, ys_e, **style)
    ax_s.axhline(1.0, color="gray", linestyle="--", label="GPipe baseline")
    ax_e.axhline(100.0, color="gray", linestyle="--")
    for ax, title, ylabel in ((ax_s, "Speedup vs GPipe", "speedup"),
                              (ax_e, "Scaling efficiency", "efficiency (%)")):
        ax.set_xticks(list(xs))
        ax.set_xticklabels(labels, rotation=45)
        ax.set_xlabel("model configuration")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.grid(alpha=0.3)
    ax_s.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_throughput_grid(rows, path: Optional[str] = None):
    """Throughput against the device count, one panel per (layers, heads),
    a line per schedule (cell 30). ``rows``: sweep rows or a DataFrame."""
    df = _frame(rows)
    plt = _mpl()
    layer_vals = sorted(df["n_layers"].unique())
    head_vals = sorted(df["n_heads"].unique())
    fig, axes = plt.subplots(len(layer_vals), len(head_vals),
                             figsize=(4 * len(head_vals),
                                      3.2 * len(layer_vals)),
                             squeeze=False)
    for i, L in enumerate(layer_vals):
        for j, H in enumerate(head_vals):
            ax = axes[i][j]
            sub = df[(df["n_layers"] == L) & (df["n_heads"] == H)]
            for schedule, g in sub.groupby("schedule"):
                g = g.sort_values("num_processes")
                ax.plot(g["num_processes"], g["throughput"], marker="o",
                        color=SCHEDULE_COLORS.get(schedule), label=schedule)
            ax.set_title(f"L{L}, H{H}", fontsize=10)
            ax.set_xlabel("devices")
            ax.set_ylabel("tokens/sec")
            ax.grid(alpha=0.3)
            if i == 0 and j == 0:
                ax.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_schedule_timeline(name_or_cs, n_devices: Optional[int] = None,
                           n_virtual: int = 1, n_microbatches: int = 4,
                           path: Optional[str] = None, ax=None,
                           annotate: bool = True):
    """Each device's ticks of the compiled tick table: a cell per action,
    coloured by op (F blue, B orange, W green), labelled with its microbatch,
    deeper virtual chunks darker; blank cells are the bubble. Takes a
    schedule name and its (D, V, M), or a ``CompiledSchedule``."""
    from matplotlib.colors import to_rgb

    from ..parallel.schedules import (CompiledSchedule, compile_schedule,
                                      placement_chunk_of,
                                      placement_device_of, simulated_bubble)
    if isinstance(name_or_cs, CompiledSchedule):
        cs = name_or_cs
    else:
        cs = compile_schedule(name_or_cs, n_devices, n_virtual,
                              n_microbatches)
    D, V = cs.n_devices, cs.n_virtual
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(
            figsize=(max(6, 0.32 * cs.makespan), 0.6 * D + 1.2))
    else:
        fig = ax.figure
    for action, tick in cs.ticks.items():
        dev = placement_device_of(cs.placement, action.stage, D)
        chunk = placement_chunk_of(cs.placement, action.stage, D)
        shade = 1.0 - 0.35 * (chunk / max(1, V - 1)) if V > 1 else 1.0
        rgb = tuple(min(1.0, c * shade) for c in to_rgb(OP_COLORS[action.op]))
        ax.add_patch(plt.Rectangle((tick, D - 1 - dev + 0.08), 1.0, 0.84,
                                   facecolor=rgb, edgecolor="white",
                                   linewidth=0.6))
        if annotate and cs.makespan <= 80:
            ax.text(tick + 0.5, D - 1 - dev + 0.5, str(action.microbatch),
                    ha="center", va="center", fontsize=7, color="black")
    ax.set_xlim(0, cs.makespan)
    ax.set_ylim(0, D)
    ax.set_yticks([D - 1 - d + 0.5 for d in range(D)])
    ax.set_yticklabels([f"device {d}" for d in range(D)])
    ax.set_xlabel("tick")
    bub = simulated_bubble(cs, 1.0, 1.0)["bubble_fraction"]
    ax.set_title(f"{cs.name}  D={D} V={V} M={cs.n_microbatches}  "
                 f"(makespan {cs.makespan} ticks, unit-cost bubble "
                 f"{bub:.1%})", fontsize=10)
    handles = [plt.Rectangle((0, 0), 1, 1, facecolor=OP_COLORS[o])
               for o in ("F", "B", "W")]
    labels = ["forward", "backward (dgrad)" if cs.split_backward
              else "backward", "weight grad"]
    n_leg = 3 if cs.split_backward else 2
    ax.legend(handles[:n_leg], labels[:n_leg], fontsize=7, loc="lower right")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_timeline_overlay(name_or_cs, timeline, n_devices: Optional[int] = None,
                          n_virtual: int = 1, n_microbatches: int = 4,
                          path: Optional[str] = None):
    """Measured against simulated timeline, stacked on one tick axis.

    Top panel: the compiled schedule's tick timeline
    (:func:`plot_schedule_timeline`, unit-cost ticks). Bottom panel: the
    measured cost of each segment of a ``utils.telemetry.PipelineTelemetry``
    timeline (tick, phase or whole step) drawn over the ticks it covers at
    height ``duration / n_ticks`` (ms a tick), so warm-up, steady state and
    cool-down line up column for column with the schedule above. A flat
    profile means the unit-cost simulation was a good model; spikes show
    where real time departs from it.

    ``timeline`` is ``PipelineTelemetry.timeline()``'s record list (or the
    ``telemetry.timeline`` section of a run report)."""
    from ..parallel.schedules import CompiledSchedule, compile_schedule
    if isinstance(name_or_cs, CompiledSchedule):
        cs = name_or_cs
    else:
        cs = compile_schedule(name_or_cs, n_devices, n_virtual,
                              n_microbatches)
    plt = _mpl()
    fig, (ax_top, ax_bot) = plt.subplots(
        2, 1, figsize=(max(6, 0.32 * cs.makespan), 0.6 * cs.n_devices + 3.4),
        sharex=True, gridspec_kw={"height_ratios": [cs.n_devices, 2.2]})
    plot_schedule_timeline(cs, ax=ax_top, annotate=cs.makespan <= 80)
    ax_top.set_xlabel("")
    for rec in timeline:
        dur = rec.get("duration_s")
        t0, n = rec.get("start_tick", 0), rec.get("n_ticks", 1)
        if dur is None or n <= 0:
            continue
        per_tick_ms = dur / n * 1e3
        ax_bot.fill_between([t0, t0 + n], 0.0, per_tick_ms,
                            color="#4e9ad1", alpha=0.55,
                            edgecolor="#2a6496", linewidth=0.8)
        if "phase" in rec and cs.makespan <= 80:
            ax_bot.text(t0 + n / 2.0, per_tick_ms, f"p{rec['phase']}",
                        ha="center", va="bottom", fontsize=6, color="#2a6496")
    ax_bot.set_xlim(0, cs.makespan)
    ax_bot.set_ylim(bottom=0.0)
    ax_bot.set_xlabel("tick")
    ax_bot.set_ylabel("measured ms/tick")
    ax_bot.grid(alpha=0.3)
    ax_bot.set_title("measured segment cost (telemetry stamps)", fontsize=9)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def _number(v) -> float:
    return float(v) if isinstance(v, (int, float)) else float("nan")


def plot_latency_curve(section, path: Optional[str] = None):
    """Latency against offered load from a ``serving_load`` section
    (``serving.loadgen.sweep_offered_load``).

    Left panel: p50/p99 TTFT and the admission-wait p99 against offered
    load (units of ring capacity), the SLO's p99 TTFT budget as a
    horizontal line and the detected saturation knee as a vertical one.
    Right panel: goodput and goodput under the SLO, which flatten (then
    part) past the knee. Percentiles missing from a row (an empty point)
    plot as gaps."""
    plt = _mpl()
    curve = section.get("curve", [])

    def col(key, pct=None):
        out = []
        for row in curve:
            v = row.get(key)
            if pct is not None:
                v = v.get(pct) if isinstance(v, dict) else None
            out.append(_number(v))
        return out

    loads = [row.get("offered_load") for row in curve]
    fig, (ax_l, ax_g) = plt.subplots(1, 2, figsize=(11, 4.2))
    ax_l.plot(loads, col("ttft_ticks", "p99"), marker="o",
              color="tab:red", label="TTFT p99")
    ax_l.plot(loads, col("ttft_ticks", "p50"), marker="o",
              color="tab:blue", label="TTFT p50")
    ax_l.plot(loads, col("admit_wait_ticks", "p99"), marker="s",
              color="tab:orange", linestyle="--", label="admission wait p99")
    slo = section.get("slo") or {}
    if isinstance(slo.get("ttft_p99_ticks"), (int, float)):
        ax_l.axhline(slo["ttft_p99_ticks"], color="gray", linestyle=":",
                     label=f"SLO p99 budget ({slo['ttft_p99_ticks']:g})")
    knee = section.get("knee") or {}
    for ax in (ax_l, ax_g):
        if isinstance(knee.get("knee_load"), (int, float)):
            ax.axvline(knee["knee_load"], color="black", linestyle="--",
                       alpha=0.6,
                       label=f"knee @ {knee['knee_load']:g} "
                             f"({knee.get('reason')})")
        ax.set_xlabel("offered load (x ring capacity)")
        ax.grid(alpha=0.3)
    ax_l.set_ylabel("latency (ticks)")
    ax_l.set_title("tail latency vs offered load")
    ax_l.legend(fontsize=8)
    ax_g.plot(loads, col("goodput"), marker="o", color="tab:green",
              label="goodput (tok/tick)")
    ax_g.plot(loads, [_number((row.get("slo") or {}).get("goodput_under_slo"))
                      for row in curve],
              marker="s", color="tab:purple", linestyle="--",
              label="goodput under SLO")
    ax_g.set_ylabel("tokens / tick")
    ax_g.set_title("goodput vs offered load")
    ax_g.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_queue_depth(summary, path: Optional[str] = None):
    """Queue depth and slot occupancy over ticks for one serving run: a
    queue ramp that precedes the TTFT blow-up, against how full the
    ring's slots are while it builds.

    ``summary`` is a ``serving_summary`` dict (or a ``serving_load`` curve
    row's ``summary``) with the block-boundary ``queue_depth`` /
    ``occupancy`` series as ``[[tick, n], ...]``; the ``n_slots`` ceiling
    is drawn when present. Step-drawn: each sample holds until the next
    block boundary, so idle gaps show as zeros, not slopes."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 3.6))
    for key, color, label in (("queue_depth", "tab:red", "admission queue"),
                              ("occupancy", "tab:blue", "busy slots")):
        series = summary.get(key) or []
        if series:
            ax.step([float(t) for t, _ in series],
                    [int(n) for _, n in series], where="post", color=color,
                    label=label)
    n_slots = summary.get("n_slots")
    if isinstance(n_slots, (int, float)):
        ax.axhline(n_slots, color="gray", linestyle=":",
                   label=f"slot count ({int(n_slots)})")
    ax.set_xlabel("tick")
    ax.set_ylabel("requests")
    ax.set_ylim(bottom=0)
    ax.set_title(f"queue depth & slot occupancy "
                 f"({summary.get('policy', '?')} policy)", fontsize=10)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
