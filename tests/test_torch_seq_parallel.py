"""Sequence parallelism (ring and Ulysses attention) in the port's
``torch.distributed`` world on the CPU, held to the JAX package's
``parallel/ring_attention.py``, ``parallel/ulysses.py``,
``parallel/seq_parallel.py`` and pp x seq executor.

Two gloo worlds (``parallel.selftest.run_cases`` under
``parallel.mesh.launch``, so the children import neither jax nor this
module) run one after the other on a thread, while the JAX references
compile here on the simulated 8-device mesh:

- 4 ranks: (e) ``ring_attention`` and ``ulysses_attention`` on a seq axis
  of 4 against the JAX functions under ``shard_map`` (causal, non-causal,
  a window, GQA kv heads; output and dq, dk, dv within 2e-5), the ring's
  dropout against an oracle that rebuilds its mask block by block from
  the (query chunk, key chunk) keys; ``make_sp_loss_fn`` (ring and
  Ulysses); (f) pipe 2 x seq 2 for ``ref_decoder``, ``gpt2`` and
  ``llama`` (GQA, 2 kv heads) with ring and Ulysses, a pad-masked loss,
  and the eval: within 2e-5 of the JAX ``make_pipeline_step`` (gpt2,
  ring) and of ``jax.value_and_grad`` of ``transformer_loss`` (the oracle
  ``tests/test_sp_pipeline.py`` holds the JAX step to at the same 2e-5);
  Ulysses with dropout against the port's own unsharded step (its masks
  are the unsharded masks' chunks and head blocks).
- 8 ranks: (g) pipe 2 x model 2 x seq 2 (Ulysses and ring), pipe 2 x
  data 2 x model 2 with FSDP and pipe 2 x data 2 x seq 2 with FSDP,
  against the oracle.

The seq ranks of a coordinate end with bitwise equal gradients. Sizes are
``tests/test_sp_pipeline.py``'s: dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 4, seq 16, weights and batches from numpy with a seed.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.ops.attention import (
    gqa_expand as jgqa_expand)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    SEQ_AXIS, make_mesh as jax_make_mesh, make_sp_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    _shard_map, make_pipeline_step)
from distributed_training_with_pipeline_parallelism_tpu.parallel.ring_attention import (
    ring_attention as jring)
from distributed_training_with_pipeline_parallelism_tpu.parallel.ulysses import (
    ulysses_attention as julysses)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    layers as tlayers)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, selftest, tensor_parallel as ttp)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
    BatchSharding)
from test_torch_tp import _numpy_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=32)
ARCHS = {"ref": dict(arch="ref_decoder"), "gpt2": dict(arch="gpt2"),
         "llama": dict(arch="llama", n_kv_heads=2)}
B, S = 4, 16
TOL = 2e-5
IMPLS = ("ring", "ulysses")
# (e): (name, impl, causal, window, kv heads, dropout rate)
ATTN = (("ring_causal", "ring", True, None, 4, 0.0),
        ("ring_full", "ring", False, None, 4, 0.0),
        ("ring_window", "ring", True, 5, 4, 0.0),
        ("ring_gqa", "ring", True, None, 2, 0.0),
        ("uly_causal", "ulysses", True, None, 4, 0.0),
        ("uly_window", "ulysses", True, 5, 4, 0.0),
        ("uly_gqa", "ulysses", True, None, 2, 0.0),
        ("ring_drop", "ring", True, None, 4, 0.3))
ATTN_SHAPE = dict(b=2, s=16, h=4, dh=8)
CONFIGS = {
    **{a: dict(BASE, **kw) for a, kw in ARCHS.items()},
    "gpt2_pad": dict(BASE, arch="gpt2", pad_token_id=0),
    "gpt2_drop": dict(BASE, arch="gpt2", dropout=0.1),
}


def _port_fields(name):
    return dict(CONFIGS[name], use_fused_xent=True)


def _jax_cfg(name):
    return dtpp.ModelConfig(**{k: v for k, v in CONFIGS[name].items()
                               if k != "dropout"})


def _batches():
    rng = np.random.default_rng(1)
    main = tuple(rng.integers(0, BASE["vocab_size"], (B, S))
                 for _ in range(2))
    pad = (main[0], main[1].copy())
    pad[1][:, -3:] = 0  # a right-padded tail: the last chunk has fewer
    return {"main": main, "pad": pad}


def _tree(name):
    return {"ref": "ref", "gpt2": "gpt2", "llama": "llama", "gpt2_pad": "gpt2",
            "gpt2_drop": "gpt2"}[name]


def _cases_a():
    cases = [dict(name=f"{a}_{impl}", kind="grad", cfg=a, tree=a,
                  sp_attn_impl=impl) for a in ARCHS for impl in IMPLS]
    cases += [dict(name="gpt2_pad_ring", kind="grad", cfg="gpt2_pad",
                   tree="gpt2", batch="pad", sp_attn_impl="ring"),
              dict(name="gpt2_drop_ulysses", kind="grad", cfg="gpt2_drop",
                   tree="gpt2", sp_attn_impl="ulysses", seed=7,
                   lockstep=True),
              dict(name="eval_ulysses", kind="eval", cfg="gpt2", tree="gpt2",
                   sp_attn_impl="ulysses")]
    for c in cases:
        c.update(schedule="1F1B", M=2, n_pipe=2, n_data=1, n_seq=2,
                 comm_overlap="none")
    for impl in IMPLS:
        cases.append(dict(name=f"sp_loss_{impl}", kind="sp_loss",
                          cfg="llama", tree="llama", sp_attn_impl=impl,
                          schedule="GPipe", M=1, n_pipe=1, n_data=1,
                          n_seq=4))
    for name, impl, causal, window, h_kv, rate in ATTN:
        cases.append(dict(name=name, kind="attn", impl=impl, causal=causal,
                          window=window, h_kv=h_kv, rate=rate, seed=5,
                          cfg="gpt2", tree="gpt2", schedule="GPipe", M=1,
                          n_pipe=1, n_data=1, n_seq=4, **ATTN_SHAPE))
    return cases


def _cases_b():
    common = dict(kind="grad", cfg="gpt2", tree="gpt2", schedule="1F1B",
                  M=2, n_pipe=2, comm_overlap="none")
    return [dict(name="pp_tp_seq", n_data=1, n_model=2, n_seq=2,
                 sp_attn_impl="ulysses", **common),
            dict(name="pp_tp_seq_ring", n_data=1, n_model=2, n_seq=2,
                 sp_attn_impl="ring", **common),
            dict(name="pp_fsdp_tp", n_data=2, n_model=2, n_seq=1, fsdp=True,
                 **common),
            dict(name="pp_fsdp_seq", n_data=2, n_model=1, n_seq=2, fsdp=True,
                 sp_attn_impl="ring", **common)]


class _Worlds:
    """Both worlds' runs in a thread of this process, joined on first
    use."""

    def __init__(self, out):
        self.out = out
        batches = _batches()
        self.spec = dict(
            cfg={}, cfgs={n: _port_fields(n) for n in CONFIGS},
            trees={t: _numpy_tree(_jax_cfg(t), 0) for t in ARCHS},
            batches=batches, tokens=batches["main"][0],
            targets=batches["main"][1], out=str(out), threads=1)
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            t = time.perf_counter()
            for key, shape, cases in (("a", (2, 1, 1, 2), _cases_a()),
                                      ("b", (2, 2, 2, 1), _cases_b())):
                self._box[key] = tmesh.launch(
                    selftest.run_cases, port.MeshConfig(*shape),
                    dict(self.spec, cases=cases), backend="gloo",
                    device="cpu", timeout_s=120)
                self._box[f"{key}_s"] = time.perf_counter() - t
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e

    def result(self):
        self._thread.join(timeout=300)
        assert not self._thread.is_alive(), "the worlds did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return self._box

    def rank(self, name, r):
        return dict(np.load(os.path.join(self.out, f"{name}_r{r}.npz")))

    def merged(self, name, cfg, shape):
        """(loss, whole gradients) of a case over a (pipe, data, model,
        seq) world: the seq ranks equal bitwise, FSDP shards concatenated
        over the data ranks, Megatron shards gathered over the model
        ranks, every rank's loss the same."""
        n_pipe, n_data, n_model, n_seq = shape
        mesh = tmesh.Mesh(n_pipe, n_data, 0, "gloo", torch.device("cpu"),
                          n_model=n_model, n_seq=n_seq)
        losses, whole = set(), {}
        for p in range(n_pipe):
            shards = []
            for j in range(n_model):
                per_data = []
                for k in range(n_data):
                    zs = [self.rank(name, mesh.rank_of(k, p, j, s))
                          for s in range(n_seq)]
                    for z in zs:
                        losses.add(float(z["loss"]))
                        for n, g in z.items():
                            assert np.array_equal(g, zs[0][n]), (name, n)
                    per_data.append(zs[0])
                dims = {n[5:]: int(d) for n, d in per_data[0].items()
                        if n.startswith("fsdp/")}
                merged = {}
                for n in (n for n in per_data[0] if n.startswith("grad/")):
                    parts = [torch.from_numpy(z[n]) for z in per_data]
                    if n[5:] in dims:
                        merged[n[5:]] = torch.cat(parts, dim=dims[n[5:]])
                    else:
                        for other in parts[1:]:
                            assert torch.equal(parts[0], other), (name, n)
                        merged[n[5:]] = parts[0]
                shards.append(merged)
            whole.update(ttp.gather_model(shards, cfg))
        assert len(losses) == 1, (name, losses)
        return losses.pop(), whole


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory.mktemp("sp"))


def _value_and_grad(name, batch="main"):
    jcfg = _jax_cfg(name)
    params = jax.tree.map(jnp.asarray, _numpy_tree(_jax_cfg(_tree(name)), 0))
    tokens, targets = _batches()[batch]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_refs():
    refs = {n: _value_and_grad(n) for n in ARCHS}
    refs["gpt2_pad"] = _value_and_grad("gpt2_pad", "pad")
    jcfg = _jax_cfg("gpt2")
    tokens, targets = _batches()["main"]
    step = make_pipeline_step(jcfg, jax_make_mesh(n_pipe=2, n_seq=2),
                              dtpp.ScheduleConfig("1F1B", 2))
    loss, grads = step(jax.tree.map(jnp.asarray, _numpy_tree(jcfg, 0)),
                       tokens, targets)
    refs["mesh_gpt2_ring"] = (float(loss), jax.tree.map(np.asarray, grads))
    return refs


def _check(name, cfg_name, loss, grads, jloss, jgrads):
    tcfg = port.ModelConfig(**_port_fields(cfg_name))
    assert abs(loss - jloss) < TOL, (name, loss, jloss)
    ref = port.from_jax_params(tcfg, jgrads, device="cpu")
    assert set(grads) == {n for n, _ in ref.named_parameters()}, name
    worst = max(float((grads[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < TOL, (name, worst)


def _attn_data():
    b, s, h, dh = (ATTN_SHAPE[k] for k in ("b", "s", "h", "dh"))
    return b, s, h, dh


def _jax_attn(impl, causal, window, h_kv):
    """The JAX function's output and (dq, dk, dv) on selftest's seeded
    inputs (``_attn_case``'s draws)."""
    b, s, h, dh = _attn_data()
    g = np.random.default_rng(0)
    q, k, v, ct = (jnp.asarray(g.standard_normal(shape).astype(np.float32))
                   for shape in ((b, s, h, dh), (b, s, h_kv, dh),
                                 (b, s, h_kv, dh), (b, s, h, dh)))

    def attn(q, k, v):
        if impl == "ring":
            k, v = jgqa_expand(k, v, h)
            return jring(q, k, v, SEQ_AXIS, causal=causal, window=window)
        return julysses(q, k, v, SEQ_AXIS, causal=causal, window=window)

    fn = _shard_map(attn, make_sp_mesh(4),
                    in_specs=(P(None, SEQ_AXIS),) * 3,
                    out_specs=P(None, SEQ_AXIS))

    @jax.jit
    def out_and_grads(q, k, v, ct):  # one compile, forward and backward
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(ct)

    return [np.asarray(x) for x in out_and_grads(q, k, v, ct)]


@pytest.mark.parametrize("case", [c for c in ATTN if c[5] == 0.0],
                         ids=[c[0] for c in ATTN if c[5] == 0.0])
def test_sp_attention_matches_jax(worlds, case):
    """(e) Each chunk's output and input gradients against the JAX ring or
    Ulysses function on the same inputs and cotangent."""
    name, impl, causal, window, h_kv, _ = case
    want = _jax_attn(impl, causal, window, h_kv)
    worlds.result()
    c = ATTN_SHAPE["s"] // 4
    for r in range(4):
        z = worlds.rank(name, r)
        for key, ref in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(z[key], ref[:, r * c:(r + 1) * c],
                                       rtol=0, atol=TOL,
                                       err_msg=f"{name} rank {r} {key}")


def test_ring_dropout_matches_block_oracle(worlds):
    """(e) The ring's dropout mask of block (q chunk i, k chunk j) is drawn
    from ``fold_seed(fold_seed(seed, i), j)`` whichever ring step handles
    it: the whole [S, S] mask rebuilt block by block and applied after a
    dense softmax gives every chunk's output."""
    worlds.result()
    name, _, _, _, _, rate = ATTN[-1]
    b, s, h, dh = _attn_data()
    D, c = 4, s // 4
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((b, s, h, dh)).astype(
        np.float32)) for _ in range(3))
    keep = torch.zeros(b, h, s, s, dtype=torch.bool)
    for i in range(D):
        for j in range(D):
            gen = tlayers.seeded_generator(
                tlayers.fold_seed(tlayers.fold_seed(5, i), j), "cpu")
            keep[:, :, i * c:(i + 1) * c, j * c:(j + 1) * c] = torch.rand(
                (b, h, c, c), generator=gen) >= rate
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool))
    probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
    probs = torch.where(keep, probs, 0.0) / (1 - rate)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, v).numpy()
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
        scores.masked_fill(~causal, -1e30), dim=-1), v).numpy()
    for r in range(4):
        got = worlds.rank(name, r)["out"]
        np.testing.assert_allclose(got, want[:, r * c:(r + 1) * c], rtol=0,
                                   atol=TOL, err_msg=f"rank {r}")
    assert np.abs(worlds.rank(name, 3)["out"] - dense[:, 3 * c:]).max() > 1e-2


@pytest.mark.parametrize("impl", IMPLS)
def test_sp_loss_fn_matches_jax(worlds, jax_refs, impl):
    """``make_sp_loss_fn`` on a seq axis of 4 (llama, GQA): the loss and
    the gradients summed over the seq group."""
    worlds.result()
    loss, grads = worlds.merged(f"sp_loss_{impl}",
                                port.ModelConfig(**_port_fields("llama")),
                                (1, 1, 1, 4))
    _check(f"sp_loss_{impl}", "llama", loss, grads, *jax_refs["llama"])


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("impl", IMPLS)
def test_pp_seq_matches_jax(worlds, jax_refs, arch, impl):
    """(f) pipe 2 x seq 2, 1F1B: every arch with both attentions."""
    worlds.result()
    name = f"{arch}_{impl}"
    loss, grads = worlds.merged(
        name, port.ModelConfig(**_port_fields(arch)), (2, 1, 1, 2))
    ref = jax_refs["mesh_gpt2_ring" if name == "gpt2_ring" else arch]
    _check(name, arch, loss, grads, *ref)


def test_pp_seq_pad_dropout_and_eval(worlds, jax_refs):
    """(f) The pad-masked loss is the global masked mean (the valid count
    summed over the seq axis, not a mean of chunk means); Ulysses with
    dropout draws the unsharded step's masks (the port's lockstep step on
    the same step seed); the eval over the seq axis."""
    worlds.result()
    shape = (2, 1, 1, 2)
    loss, grads = worlds.merged("gpt2_pad_ring", port.ModelConfig(
        **_port_fields("gpt2_pad")), shape)
    _check("gpt2_pad_ring", "gpt2_pad", loss, grads, *jax_refs["gpt2_pad"])
    tcfg = port.ModelConfig(**_port_fields("gpt2_drop"))
    loss, grads = worlds.merged("gpt2_drop_ulysses", tcfg, shape)
    lock = dict(np.load(os.path.join(worlds.out,
                                     "gpt2_drop_ulysses_lockstep.npz")))
    assert abs(loss - float(lock["loss"])) < TOL
    assert abs(loss - jax_refs["gpt2"][0]) > 1e-3
    for n, g in grads.items():
        assert float((g - torch.from_numpy(lock[f"grad/{n}"])).abs().max()) \
            < TOL, n
    losses = {float(worlds.rank("eval_ulysses", r)["loss"]) for r in range(4)}
    assert len(losses) == 1 and abs(losses.pop() - jax_refs["gpt2"][0]) < TOL


@pytest.mark.parametrize("name,shape", [("pp_tp_seq", (2, 1, 2, 2)),
                                        ("pp_tp_seq_ring", (2, 1, 2, 2)),
                                        ("pp_fsdp_tp", (2, 2, 2, 1)),
                                        ("pp_fsdp_seq", (2, 2, 1, 2))])
def test_compositions_match_jax(worlds, jax_refs, name, shape):
    """(g) The 8-rank compositions: Ulysses and the ring over each model
    rank's heads, FSDP on another dim than the Megatron one, and FSDP
    beside a seq axis (the JAX round-5 pp x fsdp x seq)."""
    worlds.result()
    loss, grads = worlds.merged(name, port.ModelConfig(
        **_port_fields("gpt2")), shape)
    _check(name, "gpt2", loss, grads, *jax_refs["gpt2"])


def _fake_mesh(n_seq=2):
    return tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_seq=n_seq)


@pytest.mark.parametrize("build,error,match", [
    (lambda cfg: port.make_pipeline_grad_fn(
        cfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu",
        mesh=_fake_mesh(), sp_attn_impl="stripe"), ValueError,
     "sp_attn_impl must be 'ring' or 'ulysses', got 'stripe'"),
    (lambda cfg: port.make_pipeline_grad_fn(
        dataclasses.replace(cfg, n_heads=2, dim=30), port.ScheduleConfig(
            "1F1B", 2), 2, device="cpu", mesh=_fake_mesh(4),
        sp_attn_impl="ulysses"), ValueError,
     r"Ulysses needs n_heads % axis size == 0 \(2 % 4\)"),
    (lambda cfg: port.make_pipeline_grad_fn(
        cfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu",
        mesh=_fake_mesh(), dynamics=True), ValueError,
     "unsupported here: a 'seq' mesh axis"),
    (lambda cfg: port.make_pipeline_grad_fn(
        cfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu",
        axes={"seq": 2}), NotImplementedError, "n_seq"),
    (lambda cfg: port.make_pipeline_loss_fn(
        cfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu",
        mesh=_fake_mesh(), sp_attn_impl="stripe"), ValueError,
     "sp_attn_impl"),
    (lambda cfg: port.make_sp_loss_fn(cfg, _fake_mesh(), "stripe"),
     ValueError, "attn_impl must be one of"),
    (lambda cfg: BatchSharding(1, 0, 3, 1).rows(np.zeros((2, 16))),
     ValueError, "does not split into 3 seq shards"),
])
def test_sp_refusals(build, error, match):
    """(h) The JAX refusals (word for word where JAX has one) and the
    port's own."""
    with pytest.raises(error, match=match):
        build(port.ModelConfig(**_port_fields("gpt2")))


def test_batch_sharding_and_window_rule():
    """A rank's part of a batch: its data rows, then its chunk of each
    sequence; a window without a causal mask raises."""
    x = np.arange(4 * 8).reshape(4, 8)
    part = BatchSharding(2, 1, 4, 2).rows(x)
    np.testing.assert_array_equal(part, x[2:, 4:6])
    mesh = _fake_mesh()
    mesh.world  # noqa: B018 (the property holds the seq axis)
    assert mesh.rank_of(0, 1, 0, 1) == 3 and mesh.shape["seq"] == 2
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.ring_attention import (
        ring_attention)
    q = torch.zeros(1, 4, 2, 4)
    with pytest.raises(ValueError, match="window requires causal"):
        ring_attention(q, q, q, mesh, causal=False, window=2)


def test_seq_dropout_masks_are_unsharded_chunks():
    """A seq rank's residual mask is its chunk of the unsharded mask, and
    under a model axis too its block of FFN columns, bitwise (the masks a
    sequence-parallel step draws are the unsharded step's)."""
    x = torch.randn(2, 4, 6)
    full = tlayers.dropout_apply(torch.cat([x] * 2, dim=1).repeat(
        1, 1, 3), 0.3, torch.Generator().manual_seed(9))
    for s in range(2):
        for j in range(3):
            got = tlayers.block_dropout(
                x, 0.3, torch.Generator().manual_seed(9),
                ((1, 2, s), (2, 3, j)))
            assert torch.equal(got, full[:, s * 4:(s + 1) * 4,
                                         j * 6:(j + 1) * 6])
