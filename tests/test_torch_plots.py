"""The port's run-report figures against the JAX package's: the measured
timeline over the compiled schedule, serving's latency against offered
load, and its queue depth. Each figure is drawn from a section the port
wrote on the CPU (a ``PipelineTelemetry`` timeline in a run report, a
``serving_load`` section, a ``serving_summary``); the JAX function draws
the same records, and the two figures must hold the same artists with
the same data."""

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from distributed_training_with_pipeline_parallelism_tpu.utils import (  # noqa: E402
    plotting as jplot)
import distributed_training_with_pipeline_parallelism_tpu_torch as port  # noqa: E402
from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (  # noqa: E402
    loadgen)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (  # noqa: E402
    plotting as tplot, telemetry)

SIZE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=64, arch="gpt2")
PROGRAM = dict(n_slots=3, max_len=24, prompt_max=12, out_max=11,
               prefill_chunk=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    cfg = port.ModelConfig(**SIZE)
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return port.ServingEngine(port.make_serving_step_fn(
        cfg, 2, device="cpu", **PROGRAM), model)


def _artists(fig):
    """Each axes' title, labels, limits and the data of its lines and
    filled regions."""
    out = []
    for ax in fig.axes:
        lines = [(ln.get_label(), np.asarray(ln.get_xydata(), float))
                 for ln in ax.get_lines()]
        fills = [np.asarray(p.vertices, float) for c in ax.collections
                 for p in c.get_paths()]
        out.append(dict(title=ax.get_title(), xlabel=ax.get_xlabel(),
                        ylabel=ax.get_ylabel(), xlim=ax.get_xlim(),
                        lines=lines, fills=fills,
                        texts=[t.get_text() for t in ax.texts]))
    return out


def _same_figures(got, want, skip_titles=()):
    import matplotlib.pyplot as plt
    a, b = _artists(got), _artists(want)
    plt.close(got)
    plt.close(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        for k in ("xlabel", "ylabel", "xlim", "texts"):
            assert x[k] == y[k], (i, k)
        if i not in skip_titles:
            assert x["title"] == y["title"], i
        assert [n for n, _ in x["lines"]] == [n for n, _ in y["lines"]]
        for (_, p), (_, q) in zip(x["lines"], y["lines"]):
            np.testing.assert_array_equal(p, q)
        assert len(x["fills"]) == len(y["fills"])
        for p, q in zip(x["fills"], y["fills"]):
            np.testing.assert_array_equal(p, q)


def test_timeline_overlay_from_a_port_report(tmp_path):
    """A stamped 1F1B step at D = 2 in a run report: the overlay draws a
    measured band per tick under the schedule, as JAX's draws it (the
    bottom panel's title names the port's stamps)."""
    cfg = port.ModelConfig(**SIZE)
    sched = port.ScheduleConfig("1F1B", 4)
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tel = telemetry.PipelineTelemetry()
    tokens = torch.randint(0, 64, (4, 8), generator=torch.Generator()
                           .manual_seed(1))
    port.make_pipeline_grad_fn(cfg, sched, 2, device="cpu",
                               telemetry=tel)(model, tokens, tokens)
    report = telemetry.RunReport(name="overlay")
    report.attach_telemetry(tel)
    manifest = report.manifest()
    telemetry.validate_report(manifest)
    timeline = manifest["telemetry"]["timeline"]
    cs = port.compile_schedule("1F1B", 2, 1, 4)
    assert len(timeline) == cs.table.shape[0]
    out = tmp_path / "overlay.png"
    fig = tplot.plot_timeline_overlay("1F1B", timeline, 2, 1, 4,
                                      path=str(out))
    assert out.stat().st_size > 0
    assert len(fig.axes[1].collections) == len(timeline)
    _same_figures(fig, jplot.plot_timeline_overlay("1F1B", timeline, 2, 1, 4),
                  skip_titles=(1,))


def test_latency_curve_from_a_port_load_sweep(engine, tmp_path):
    """``sweep_offered_load``'s section over three loads: TTFT p50/p99,
    the admission wait, goodput, the SLO budget and the knee, line for
    line as JAX draws them."""
    section = loadgen.sweep_offered_load(engine, [0.5, 1.0, 2.0],
                                         n_requests=6)
    out = tmp_path / "curve.png"
    fig = tplot.plot_latency_curve(section, path=str(out))
    assert out.stat().st_size > 0
    labels = [ln.get_label() for ln in fig.axes[0].get_lines()]
    assert labels[:3] == ["TTFT p99", "TTFT p50", "admission wait p99"]
    assert any(lb.startswith("SLO p99 budget") for lb in labels)
    ys = fig.axes[0].get_lines()[0].get_ydata()
    assert list(ys) == [float(r["ttft_ticks"]["p99"])
                        for r in section["curve"]]
    _same_figures(fig, jplot.plot_latency_curve(section))


def test_queue_depth_from_a_port_serving_summary(engine, tmp_path):
    """A continuous run of 8 requests: the queue and occupancy series of
    its ``serving_summary`` drawn as steps under the slot count, as JAX
    draws them."""
    trace = loadgen.make_workload(8, "mixed", prefill_chunk=2, load=2.0,
                                  vocab_size=64, seed=3)
    summary = telemetry.serving_summary(engine.run(trace))
    summary["n_slots"] = PROGRAM["n_slots"]
    out = tmp_path / "queue.png"
    fig = tplot.plot_queue_depth(summary, path=str(out))
    assert out.stat().st_size > 0
    lines = {ln.get_label(): ln for ln in fig.axes[0].get_lines()}
    assert lines["busy slots"].get_ydata().max() <= PROGRAM["n_slots"]
    assert len(summary["queue_depth"]) > 1
    _same_figures(fig, jplot.plot_queue_depth(summary))
