"""The PyTorch port's boundary: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_training_with_pipeline_parallelism_tpu_torch as port

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
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}, bad


_CFG = port.gpt2_config("small", dim=32, n_layers=2, n_heads=2,
                        vocab_size=31, ffn_dim=64, max_seq_len=16)


@pytest.mark.parametrize("entry", ["init_params", "generate", "pipeline",
                                   "from_jax_params", "pipeline_grad",
                                   "train_step"])
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
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
