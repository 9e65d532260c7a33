"""Pipelined batch inference (``make_pipeline_forward``) of the port on the
CPU, held to the JAX package's ``make_pipeline_forward`` on the simulated
8-device mesh.

- Lockstep: GPipe at D = 4, 1F1B with M < D (no schedule is compiled, so
  1F1B's M >= D does not apply), V = 2 chunks, tied embeddings (JAX
  ``test_pipeline.py:144,175``, ``test_eval.py:112``,
  ``test_tied_embeddings.py:95``): f32 logits within 1e-5 of JAX's and of
  the port's single-device ``transformer_apply``; the mixed-precision
  config (bf16 compute over f32 masters, ``test_mixed_precision.py:76``)
  no farther from the f32 logits than 1.5 times JAX's bf16 logits are.
- A world of 4 gloo ranks (``parallel.selftest.run_cases`` under
  ``parallel.mesh.launch``, on a thread while the JAX side compiles) as
  pipe 2 x data 2 (``test_pipeline.py:162``) and pipe 2 x model 2, V = 1
  and 2 (``test_tp_pipeline.py:190``): each rank's logits equal JAX's rows
  of its data shard within 1e-5, the same on every pipe and model rank.
- The refusals, in JAX's words.

Sizes are the JAX tests': gpt2, dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 8 (4 on the model axis), seq 8; weights and tokens from numpy
with a seed.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    pipeline as jpipe)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    transformer as ttfm)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, selftest)
from test_torch_tp import _numpy_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S = 8, 8
TOL = 1e-5
# (schedule, D, M, V, tied): JAX test_pipeline.py:144 (D = 4, M = 4),
# :175 (1F1B, M = 2 < D = 4), test_eval.py:112 (V = 2), and tied
LOCKSTEP = (("GPipe", 4, 4, 1, False), ("1F1B", 4, 2, 1, False),
            ("GPipe", 2, 2, 2, False), ("GPipe", 2, 2, 1, True))
# (name, mesh (pipe, data, model), schedule, M, V, tied, batch)
WORLD = (("pp_dp", (2, 2, 1), "1F1B", 2, 1, False, B),
         ("pp_tp", (2, 1, 2), "GPipe", 2, 1, True, 4),
         ("pp_tp_v2", (2, 1, 2), "GPipe", 2, 2, True, 4))


def _tokens(b=B):
    return np.random.default_rng(1).integers(0, BASE["vocab_size"], (b, S))


def _tree(tied):
    return _numpy_tree(dtpp.ModelConfig(**BASE, tie_embeddings=tied), 0)


def _jax_forward(mesh, name, M, V, tied, tokens, **cfg_kw):
    cfg = dtpp.ModelConfig(**BASE, tie_embeddings=tied, **cfg_kw)
    params = jax.tree.map(jnp.asarray, _tree(tied))
    fwd = jpipe.make_pipeline_forward(cfg, mesh,
                                      dtpp.ScheduleConfig(name, M, V))
    return np.asarray(jax.device_get(fwd(params, tokens)), np.float32)


class _World:
    """The world's run on a thread of this process, joined on first use."""

    def __init__(self, out):
        self.out = out
        cases = [dict(name=n, kind="forward", cfg=f"tied{tied}",
                      tree=f"tied{tied}", schedule=s, M=M, n_virtual=V,
                      n_pipe=p, n_data=d, n_model=m, batch=f"b{b}")
                 for n, (p, d, m), s, M, V, tied, b in WORLD]
        self.spec = dict(
            cfg={}, cfgs={f"tied{t}": dataclasses.asdict(port.ModelConfig(
                **BASE, tie_embeddings=t)) for t in (False, True)},
            trees={f"tied{t}": _tree(t) for t in (False, True)},
            batches={f"b{b}": (_tokens(b), _tokens(b)) for b in (4, B)},
            tokens=_tokens(), targets=_tokens(), out=str(out), threads=1,
            cases=cases)
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            self._box["ranks"] = tmesh.launch(
                selftest.run_cases, port.MeshConfig(2, 2), self.spec,
                backend="gloo", device="cpu", timeout_s=120)
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e

    def logits(self, name, rank):
        self._thread.join(timeout=300)
        assert not self._thread.is_alive(), "the world did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return np.load(os.path.join(self.out, f"{name}_r{rank}.npz"))[
            "logits"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(tmp_path_factory.mktemp("forward"))


@pytest.mark.parametrize("name,D,M,V,tied", LOCKSTEP)
def test_lockstep_forward_matches_jax(name, D, M, V, tied):
    tokens = _tokens()
    want = _jax_forward(jax_make_mesh(n_pipe=D), name, M, V, tied, tokens)
    cfg = port.ModelConfig(**BASE, tie_embeddings=tied)
    model = port.from_jax_params(cfg, _tree(tied), device="cpu")
    fwd = port.make_pipeline_forward(cfg, port.ScheduleConfig(name, M, V), D,
                                     device="cpu")
    got = fwd(model, tokens)
    assert got.dtype == torch.float32 and got.shape == (B, S, 64)
    assert np.abs(got.numpy() - want).max() < TOL
    with torch.no_grad():
        single = ttfm.transformer_apply(cfg, model, torch.as_tensor(tokens))
    assert float((got - single).abs().max()) < TOL


def test_mixed_precision_forward_matches_jax():
    """bf16 compute over f32 masters (JAX ``test_mixed_precision.py:76``
    checks shape and finiteness): the JAX and port programs round in bf16
    along different paths, so each is held to the f32 logits of the same
    weights: the port's finite f32 [B, S, V] logits are no farther from
    them than 1.5 times JAX's bf16 logits are."""
    kw = dict(dtype="bfloat16", param_dtype="float32")
    tokens = _tokens(4)
    mesh = jax_make_mesh(n_pipe=2)
    want = _jax_forward(mesh, "GPipe", 2, 1, False, tokens, **kw)
    exact = _jax_forward(mesh, "GPipe", 2, 1, False, tokens)
    cfg = port.ModelConfig(**BASE, **kw)
    model = port.from_jax_params(cfg, _tree(False), device="cpu")
    got = port.make_pipeline_forward(cfg, port.ScheduleConfig("GPipe", 2), 2,
                                     device="cpu")(model, tokens).numpy()
    assert got.dtype == np.float32 and got.shape == (4, S, 64)
    assert np.isfinite(got).all()
    assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max()


@pytest.mark.parametrize("case", WORLD, ids=[w[0] for w in WORLD])
def test_world_forward_matches_jax(world, case):
    name, (p, d, m), sched, M, V, tied, b = case
    tokens = _tokens(b)
    want = _jax_forward(jax_make_mesh(n_pipe=p, n_data=d, n_model=m), sched,
                        M, V, tied, tokens)
    mesh = tmesh.Mesh(p, d, 0, "gloo", torch.device("cpu"), n_model=m)
    rows = b // d
    for k in range(d):
        for pp in range(p):
            for j in range(m):
                got = world.logits(name, mesh.rank_of(k, pp, j))
                assert got.shape == (rows, S, 64)
                err = np.abs(got - want[k * rows:(k + 1) * rows]).max()
                assert err < TOL, (name, k, pp, j, err)


def _fake_mesh(**kw):
    return tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), **kw)


@pytest.mark.parametrize("mesh_kw,axis", [(dict(n_seq=2), "seq"),
                                          (dict(n_expert=2), "expert")])
def test_forward_refuses_seq_and_expert_axes(mesh_kw, axis):
    cfg = port.ModelConfig(**BASE)
    with pytest.raises(NotImplementedError) as e:
        port.make_pipeline_forward(cfg, port.ScheduleConfig("GPipe", 2), 2,
                                   device="cpu", mesh=_fake_mesh(**mesh_kw))
    assert str(e.value) == (
        f"make_pipeline_forward supports data x pipe x model meshes (got a "
        f"'{axis}' axis); for eval losses on SP/MoE meshes use "
        f"make_pipeline_loss_fn")


def test_forward_layer_split_refusal():
    cfg = port.ModelConfig(**BASE)
    with pytest.raises(ValueError, match="n_layers=4 must divide over 6 "
                                         "stages"):
        port.make_pipeline_forward(cfg, port.ScheduleConfig("GPipe", 2, 2), 3,
                                   device="cpu")
