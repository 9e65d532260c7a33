"""The PyTorch port's boundary: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import serving
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    calibration)
from distributed_training_with_pipeline_parallelism_tpu_torch.probe import (
    main as probe_main)
from distributed_training_with_pipeline_parallelism_tpu_torch.train import (
    main as train_main)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
    prefetch_to_device)

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "distributed_training_with_pipeline_parallelism_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "distributed_training_with_pipeline_parallelism_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(PORT_DIR)) for f in files
             if PORT_DIR in f.parents}
    assert {"analysis/cost_model.py", "analysis/memory_model.py",
            "run_sweep.py", "utils/sweep.py", "utils/plotting.py",
            "train.py", "utils/resilience.py", "utils/checkpoint.py",
            "utils/data.py", "utils/data_native.py", "utils/dynamics.py",
            "utils/profiling.py", "utils/telemetry.py", "parallel/mesh.py",
            "parallel/selftest.py", "analysis/table_check.py",
            "analysis/schedule_search.py", "search_schedule.py",
            "analysis/calibration.py", "analysis/cli.py",
            "analysis/__main__.py", "probe.py", "serving/bench.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}, bad


_CFG = port.gpt2_config("small", dim=32, n_layers=2, n_heads=2,
                        vocab_size=31, ffn_dim=64, max_seq_len=16)
_SERVING = dict(n_slots=2, max_len=8, prompt_max=4, out_max=4)


@pytest.mark.parametrize("entry", ["init_params", "generate", "pipeline",
                                   "from_jax_params", "pipeline_grad",
                                   "train_step", "serving_step_fn",
                                   "serving_engine", "serve_bench",
                                   "sweep_experiment", "loss_fn", "fit",
                                   "prefetch", "train_main", "launch",
                                   "train_world", "run_probe",
                                   "paged_bench", "spec_bench",
                                   "probe_main"])
def test_entry_points_default_to_cuda(entry):
    """Without ``device=`` an entry point asks for CUDA: on a host without
    it the call raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    model = port.init_params(_CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    prompt = np.zeros((2, 3), np.int64)
    calls = {
        "init_params": lambda: port.init_params(
            _CFG, torch.Generator().manual_seed(0)),
        "generate": lambda: port.generate(_CFG, model, prompt, 2),
        "pipeline": lambda: port.make_pipeline_generate_fn(_CFG, 2, 2),
        "from_jax_params": lambda: port.from_jax_params(_CFG, {}),
        "pipeline_grad": lambda: port.make_pipeline_grad_fn(
            _CFG, port.ScheduleConfig("1F1B", 2), 2),
        "train_step": lambda: port.make_train_step(
            _CFG, port.ScheduleConfig("GPipe", 2), 2, port.adamw()),
        "serving_step_fn": lambda: port.make_serving_step_fn(
            _CFG, 2, **_SERVING),
        "serving_engine": lambda: port.ServingEngine(
            port.make_serving_step_fn(_CFG, 2, **_SERVING), model),
        "serve_bench": lambda: port.run_serve_bench(n_requests=2),
        "sweep_experiment": lambda: port.run_one_experiment(4, 4, 2, "GPipe"),
        "loss_fn": lambda: port.make_pipeline_loss_fn(
            _CFG, port.ScheduleConfig("1F1B", 2), 2),
        "fit": lambda: port.fit(_CFG, port.ScheduleConfig("1F1B", 2), 2,
                                model, iter([]), 1),
        "prefetch": lambda: next(prefetch_to_device(iter([(prompt,)]))),
        "train_main": lambda: train_main(["--model", "gpt2-small",
                                          "--steps", "1"]),
        "launch": lambda: port.launch(print, port.MeshConfig(2, 1),
                                      backend="gloo"),
        "train_world": lambda: train_main(["--model", "gpt2-small",
                                           "--steps", "1", "--backend",
                                           "gloo"]),
        "run_probe": lambda: calibration.run_probe(
            calibration.probe_grid()[0]),
        "paged_bench": lambda: serving.run_paged_bench(n_requests=2),
        "spec_bench": lambda: serving.run_spec_bench(n_requests=2),
        "probe_main": lambda: probe_main([]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
