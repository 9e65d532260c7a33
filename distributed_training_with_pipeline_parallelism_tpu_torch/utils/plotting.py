"""The reference notebook's sweep figures (the port's own copy of the JAX
package's ``utils/plotting.py``): speedup and scaling efficiency by model
configuration, throughput against devices per (layers, heads), and the
per-device timeline of a compiled tick table. pandas and matplotlib are
imported inside the functions (the H100 host has neither; the sweep's CSV
is plotted where they are installed)."""

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
