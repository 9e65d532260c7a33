"""Megatron tensor parallelism in the port's ``torch.distributed`` world on
the CPU, held to the JAX package.

Two gloo worlds (``parallel.selftest.run_cases`` under
``parallel.mesh.launch``, so the children import neither jax nor this
module) run every case of their shape, one after the other on a thread,
while the JAX references compile here:

- pipe 2 x model 2 (4 ranks): ``ref_decoder``, ``gpt2`` and ``llama``
  (GQA, 2 kv heads) under GPipe and 1F1B; gpt2 under Interleaved1F1B (V
  = 2) and ZBH1; the vocab-parallel head untied (ref_decoder, whose bias
  splits too, and llama), tied, and tied with pad masking;
  ``tp_overlap="ring"`` (gpt2, llama) with its hop count; ref_decoder
  with dropout against the port's own lockstep step; and
  ``make_tp_grad_fn`` on pipe 1 x data 2 x model 2.
- data 2 x pipe 2 x model 2 (8 ranks): gpt2 under 1F1B, the vocab-parallel
  head with a data axis, and clipped AdamW and ZeRO-1 steps against the
  lockstep train step.

Tolerances are the JAX tests' own (``tests/test_tp_pipeline.py``): the
loss and every leaf, gathered over the model ranks, within 2e-5 of the
JAX reference: ``make_pipeline_step`` on the (pipe 2, model 2) mesh for
gpt2 under 1F1B, ``jax.value_and_grad`` of ``transformer_loss`` (the
oracle the JAX mesh step is held to, at the same 2e-5) elsewhere, and the
JAX ``make_tp_grad_fn`` for the port's. Leaves that stay replicated over
the model axis are equal on every model rank, bitwise. The ring's
all-gather matmul equals the unfused gather-then-matmul bitwise. Sizes
are ``tests/test_tp_pipeline.py``'s: dim 32, 4 layers, 4 heads, vocab 64,
ffn 64, batch 8, seq 6, weights and batches from numpy with a seed.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    tensor_parallel as jtp)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    make_pipeline_step)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    collectives as tcol, layers as tlayers)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh, selftest, tensor_parallel as ttp)
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16)
ARCHS = {"ref": dict(arch="ref_decoder"), "gpt2": dict(arch="gpt2"),
         "llama": dict(arch="llama", n_kv_heads=2)}
B, S = 8, 6
TOL = 2e-5
# (steps, adamw fields): one moving update, clipped (the gradient's norm
# is ~10 at these weights). A tighter clip would scale its smallest
# element (~7e-7) into Adam's eps regime, where an update is g / (|g| +
# eps) and the model axis's other summation order moves it by 1e-4 or
# more (ROADMAP.md Queue 3: Adam turns rounding noise into moves)
TRAIN = (2, dict(learning_rate=1e-2, warmup_steps=1, max_grad_norm=5.0))

# name -> (config fields, tree, batch)
CONFIGS = {
    **{a: (dict(BASE, **kw), a, "main") for a, kw in ARCHS.items()},
    "gpt2_tied": (dict(BASE, arch="gpt2", tie_embeddings=True), "gpt2_tied",
                  "main"),
    "gpt2_tied_pad": (dict(BASE, arch="gpt2", tie_embeddings=True,
                           pad_token_id=0), "gpt2_tied", "pad"),
    "gpt2_ring": (dict(BASE, arch="gpt2", tp_overlap="ring"), "gpt2",
                  "main"),
    "llama_ring": (dict(BASE, **ARCHS["llama"], tp_overlap="ring"), "llama",
                   "main"),
    "ref_drop": (dict(BASE, arch="ref_decoder", dropout=0.1), "ref", "main"),
}


def _port_fields(name):
    fields, _, _ = CONFIGS[name]
    flash = "auto" if fields.get("dropout") else True
    return dict(fields, use_flash_attention=flash, use_fused_xent=True)


def _jax_cfg(name):
    fields = {k: v for k, v in CONFIGS[name][0].items() if k != "tp_overlap"}
    return dtpp.ModelConfig(**fields, use_flash_attention=False)


def _numpy_tree(cfg, seed):
    """A JAX-layout pytree of ``cfg``'s shapes (``transformer_init``'s
    structure) with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jtfm.transformer_init(jax.random.key(0),
                                                          cfg))

    def leaf(path, s):
        key = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if key.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif key.endswith("['w']"):
            x = x * s.shape[-2] ** -0.5
        elif "tok" in key:
            x = 0.5 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches():
    rng = np.random.default_rng(1)
    main = tuple(rng.integers(0, BASE["vocab_size"], (B, S))
                 for _ in range(2))
    pad = (main[0], main[1].copy())
    pad[1][:, -2:] = 0  # a right-padded tail
    return {"main": main, "pad": pad}


TREES = {"ref": "ref", "gpt2": "gpt2", "llama": "llama",
         "gpt2_tied": "gpt2_tied"}


def _cases_a():
    cases = [dict(name=f"{a}_{s}", cfg=a, tree=a, schedule=s, M=4)
             for a in ARCHS for s in ("GPipe", "1F1B")]
    cases += [
        dict(name="gpt2_il", cfg="gpt2", tree="gpt2",
             schedule="Interleaved1F1B", n_virtual=2, M=4),
        dict(name="gpt2_zbh1", cfg="gpt2", tree="gpt2", schedule="ZBH1",
             M=4),
        dict(name="vp_ref", cfg="ref", tree="ref", schedule="1F1B", M=4,
             vocab_parallel=True),
        dict(name="vp_llama", cfg="llama", tree="llama", schedule="1F1B",
             M=4, vocab_parallel=True),
        dict(name="vp_gpt2_tied", cfg="gpt2_tied", tree="gpt2_tied",
             schedule="1F1B", M=4, vocab_parallel=True),
        dict(name="vp_gpt2_tied_pad", cfg="gpt2_tied_pad", tree="gpt2_tied",
             batch="pad", schedule="GPipe", M=2, vocab_parallel=True),
        dict(name="ring_gpt2", cfg="gpt2_ring", tree="gpt2",
             schedule="1F1B", M=4),
        dict(name="ring_llama", cfg="llama_ring", tree="llama",
             schedule="1F1B", M=4),
        dict(name="drop_ref", cfg="ref_drop", tree="ref", schedule="1F1B",
             M=4, seed=7, lockstep=True)]
    for c in cases:
        c.update(kind="grad", n_pipe=2, n_data=1, n_model=2,
                 comm_overlap="none")
    cases.append(dict(name="tp_fn", kind="tp_grad_fn", cfg="gpt2",
                      tree="gpt2", schedule="GPipe", M=1, n_pipe=1,
                      n_data=2, n_model=2, vocab_parallel=True))
    return cases


def _cases_b():
    common = dict(n_pipe=2, n_data=2, n_model=2, comm_overlap="none")
    return [
        dict(name="3d_gpt2", kind="grad", cfg="gpt2", tree="gpt2",
             schedule="1F1B", M=2, **common),
        dict(name="3d_vp_gpt2", kind="grad", cfg="gpt2", tree="gpt2",
             schedule="GPipe", M=2, vocab_parallel=True, **common),
        dict(name="3d_train", kind="train", cfg="gpt2_tied",
             tree="gpt2_tied", schedule="1F1B", M=2, vocab_parallel=True,
             steps=TRAIN[0], opt=TRAIN[1], **common)]


class _Worlds:
    """Both worlds' runs in a thread of this process, joined on first
    use."""

    def __init__(self, out):
        self.out = out
        cfgs = {n: _port_fields(n) for n in CONFIGS}
        trees = {t: _numpy_tree(_jax_cfg(t), 0) for t in TREES}
        batches = _batches()
        self.spec = dict(cfg={}, cfgs=cfgs, trees=trees, batches=batches,
                         tokens=batches["main"][0],
                         targets=batches["main"][1], out=str(out),
                         threads=1)
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            t = time.perf_counter()
            for key, shape, cases in (("a", (2, 1, 2), _cases_a()),
                                      ("b", (2, 2, 2), _cases_b())):
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

    def merged(self, name, cfg, shape, vocab_parallel=False):
        """(loss, whole gradients) of a case over the (pipe, data, model)
        world ``shape``: each pipe rank's model shards gathered, a leaf
        replicated over the model axis equal on every model rank, the
        data replicas equal, every rank's loss the same."""
        n_pipe, n_data, n_model = shape
        mesh = tmesh.Mesh(n_pipe, n_data, 0, "gloo", torch.device("cpu"),
                          n_model=n_model)
        losses, whole, replicas = set(), {}, []
        for k in range(n_data):
            merged = {}
            for p in range(n_pipe):
                shards = []
                for j in range(n_model):
                    z = self.rank(name, mesh.rank_of(k, p, j))
                    losses.add(float(z["loss"]))
                    shards.append({n[5:]: torch.from_numpy(v)
                                   for n, v in z.items()
                                   if n.startswith("grad/")})
                for n, g in shards[0].items():
                    if ttp.split_dim(cfg, n, vocab_parallel) is None:
                        for other in shards[1:]:
                            assert torch.equal(g, other[n]), (name, n)
                merged.update(ttp.gather_model(shards, cfg, vocab_parallel))
            replicas.append(merged)
        for other in replicas[1:]:
            for n, g in replicas[0].items():
                assert torch.equal(g, other[n]), (name, n)
        whole = replicas[0]
        assert len(losses) == 1, (name, losses)
        return losses.pop(), whole


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory.mktemp("tp"))


def _jax_value_and_grad(name, batch="main"):
    jcfg = _jax_cfg(name)
    tree = _numpy_tree(_jax_cfg(CONFIGS[name][1]), 0)
    tokens, targets = _batches()[batch]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(
            jax.tree.map(jnp.asarray, tree))
    return float(loss), jax.tree.map(np.asarray, grads)


def _check(name, loss, grads, jloss, jgrads, cfg_name):
    tcfg = port.ModelConfig(**_port_fields(cfg_name))
    assert abs(loss - jloss) < TOL, (name, loss, jloss)
    ref = port.from_jax_params(tcfg, jgrads, device="cpu")
    assert set(grads) == {n for n, _ in ref.named_parameters()}, name
    worst = max(float((grads[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < TOL, (name, worst)


def test_tp_worlds_match_jax(worlds):
    """Every case of both worlds against the JAX references (see the
    module doc); the JAX side compiles while the worlds run."""
    jref = {name: _jax_value_and_grad(name, CONFIGS[name][2])
            for name in ("ref", "gpt2", "llama", "gpt2_tied",
                         "gpt2_tied_pad")}
    # the JAX executor itself on its (pipe 2, model 2) mesh
    jcfg = _jax_cfg("gpt2")
    tokens, targets = _batches()["main"]
    step = make_pipeline_step(jcfg, jax_make_mesh(n_pipe=2, n_model=2),
                              dtpp.ScheduleConfig("1F1B", 4))
    mloss, mgrads = step(jax.tree.map(jnp.asarray,
                                      _numpy_tree(jcfg, 0)), tokens, targets)
    mesh_ref = (float(mloss), jax.tree.map(np.asarray, mgrads))
    # the JAX GSPMD make_tp_grad_fn on (data 2, model 2)
    jtree = jax.tree.map(jnp.asarray, _numpy_tree(jcfg, 0))
    jmesh = jtp.make_tp_mesh(n_model=2, n_data=2)
    tloss, tgrads = jtp.make_tp_grad_fn(jcfg, jmesh)(
        jtp.shard_params(jtree, jcfg, jmesh), tokens, targets)
    tp_fn_ref = (float(tloss), jax.tree.map(np.asarray, tgrads))
    box = worlds.result()
    for r in box["a"] + box["b"]:
        assert not {"jax", "jaxlib", "distributed_training_with_pipeline_"
                    "parallelism_tpu"} & set(r["modules"]), r["modules"]

    shape_a, shape_b = (2, 1, 2), (2, 2, 2)
    for case in _cases_a() + _cases_b():
        name, cfg_name = case["name"], case["cfg"]
        if case["kind"] != "grad":
            continue
        tcfg = port.ModelConfig(**_port_fields(cfg_name))
        shape = shape_b if name.startswith("3d") else shape_a
        loss, grads = worlds.merged(name, tcfg, shape,
                                    case.get("vocab_parallel", False))
        if name == "drop_ref":
            continue  # against the port's lockstep step, below
        key = cfg_name.replace("_ring", "") if cfg_name.endswith("_ring") \
            else cfg_name
        ref = mesh_ref if name == "gpt2_1F1B" else jref[key]
        _check(name, loss, grads, *ref, cfg_name)

    # "ring" against "none": the same step within the tolerance, the hops
    # ring_matmul_hops counts: 3 (gpt2) or 4 (llama) ring forms per MLP,
    # forward and backward alike, in each F unit and twice in each B unit
    # (its recompute and its backward); 2 layers per rank, 4 microbatches
    for arch, forms in (("gpt2", 3), ("llama", 4)):
        tcfg = port.ModelConfig(**_port_fields(arch))
        none = worlds.merged(f"{arch}_1F1B", tcfg, shape_a)
        ring = worlds.merged(f"ring_{arch}", tcfg, shape_a)
        assert abs(none[0] - ring[0]) < TOL
        for n, g in none[1].items():
            assert float((g - ring[1][n]).abs().max()) < TOL, n
        for r in range(4):
            assert int(worlds.rank(f"ring_{arch}", r)["hops"]) == \
                tcol.ring_matmul_hops(2, forms * 2 * 4 * 3)
            assert int(worlds.rank(f"{arch}_1F1B", r)["hops"]) == 0

    # dropout: the world's step against the port's lockstep step on the
    # same step seed (the masks of every shard are the lockstep masks'
    # blocks; row-parallel sums round in another order)
    tcfg = port.ModelConfig(**_port_fields("ref_drop"))
    loss, grads = worlds.merged("drop_ref", tcfg, shape_a)
    lock = dict(np.load(os.path.join(worlds.out, "drop_ref_lockstep.npz")))
    assert abs(loss - float(lock["loss"])) < TOL
    assert abs(loss - worlds.merged("ref_1F1B", tcfg, shape_a)[0]) > 1e-3
    for n, g in grads.items():
        assert float((g - torch.from_numpy(lock[f"grad/{n}"])).abs().max()) \
            < TOL, n

    # make_tp_grad_fn against the JAX GSPMD one (head split over the vocab)
    tcfg = port.ModelConfig(**_port_fields("gpt2"))
    loss, grads = worlds.merged("tp_fn", tcfg, (1, 2, 2), True)
    _check("tp_fn", loss, grads, *tp_fn_ref, "gpt2")


def test_tp_train_steps_match_lockstep(worlds):
    """Clipped AdamW and ZeRO-1 steps of the 8-rank world (tied gpt2, the
    vocab-parallel head) against the lockstep train step on the whole
    model and batch: every update's clipping norm within 1e-5 relative
    (a replicated leaf counted once, not once per model rank), every
    parameter, gathered, within test_torch_train's AdamW bounds."""
    worlds.result()
    steps, opt = TRAIN
    tcfg = port.ModelConfig(**_port_fields("gpt2_tied"))
    ref = dict(np.load(os.path.join(worlds.out, "3d_train_lockstep.npz")))
    norms = ref["lockstep/norms"]
    assert len(norms) == steps and (norms > opt["max_grad_norm"]).all()
    mesh = tmesh.Mesh(2, 2, 0, "gloo", torch.device("cpu"), n_model=2)
    for label in ("plain", "zero1"):
        for k in range(2):
            for p in range(2):
                zs = [worlds.rank("3d_train", mesh.rank_of(k, p, j))
                      for j in range(2)]
                for z in zs:
                    np.testing.assert_allclose(z[f"{label}/norms"], norms,
                                               rtol=1e-5, err_msg=label)
                for i in range(steps):
                    prefix = f"{label}/{i}/param/"
                    shards = [{n[len(prefix):]: torch.from_numpy(v)
                               for n, v in z.items() if n.startswith(prefix)}
                              for z in zs]
                    for n, t in ttp.gather_model(shards, tcfg).items():
                        atol = (2 * opt["learning_rate"] * i
                                if n.endswith("attn.k.bias") else 1e-4)
                        np.testing.assert_allclose(
                            t.numpy(), ref[f"lockstep/{i}/param/{n}"],
                            rtol=1e-5, atol=atol,
                            err_msg=f"{label} step {i}: {n}")


def test_collective_matmul_and_dropout_blocks():
    """The ring's all-gather matmul equals the unfused all-gather then
    matmul bitwise, its reduce-scatter the unfused one within 2e-5 (ring
    order), ``resolve_tp_overlap``'s modes; a sharded dropout mask is the
    full mask's block, bitwise."""
    box = tmesh.launch(selftest.ring_blocks, port.MeshConfig(1, 1, 2),
                       backend="gloo", device="cpu", timeout_s=60)
    for r in box:
        assert r["gather_equal"], r
        assert r["scatter_err"] < TOL, r
        assert r["hops"] == tcol.ring_matmul_hops(2, 2), r
    assert ttp.resolve_tp_overlap("none", 4, 16) == "none"
    assert ttp.resolve_tp_overlap("ring", 4, 16) == "ring"
    assert ttp.resolve_tp_overlap("auto", 4, 16) == "none"
    with pytest.raises(ValueError, match="divis"):
        ttp.resolve_tp_overlap("ring", 4, 6)
    with pytest.raises(ValueError, match="tp_overlap"):
        ttp.resolve_tp_overlap("bogus", 4, 16)
    with pytest.raises(ValueError, match="tp_overlap"):
        port.ModelConfig(tp_overlap="sidecar")
    x = torch.randn(2, 8, 6, 4)
    full = tlayers.dropout_apply(x.repeat(1, 2, 1, 1), 0.3,
                                 torch.Generator().manual_seed(3))
    for j in range(2):
        got = tlayers.sharded_dropout_apply(
            x, 0.3, torch.Generator().manual_seed(3), 2, j, shard_dim=1)
        assert torch.equal(got, full[:, j * 8:(j + 1) * 8])


@pytest.mark.parametrize("fields,vp,match", [
    (dict(dim=30, n_heads=3), False, "divisible"),
    (dict(n_kv_heads=1, arch="llama"), False, "divisible"),
    (dict(ffn_dim=63), False, "divisible"),
    (dict(vocab_size=63), True, "divide over"),
])
def test_tp_rejects_indivisible_shapes(fields, vp, match):
    cfg = port.ModelConfig(**{**BASE, "arch": "gpt2", **fields})
    mesh = tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_model=2)
    with pytest.raises(ValueError, match=match):
        port.make_pipeline_grad_fn(cfg, port.ScheduleConfig("GPipe", 4), 2,
                                   device="cpu", mesh=mesh,
                                   tp_vocab_parallel=vp)


def test_tp_needs_a_world_and_a_shard():
    cfg = port.ModelConfig(**dict(BASE, arch="gpt2"))
    sched = port.ScheduleConfig("1F1B", 4)
    with pytest.raises(NotImplementedError, match="torch.distributed world"):
        port.make_pipeline_grad_fn(cfg, sched, 2, device="cpu",
                                   axes={"model": 2})
    with pytest.raises(ValueError, match="'model' mesh axis"):
        port.make_pipeline_grad_fn(cfg, sched, 2, device="cpu",
                                   tp_vocab_parallel=True)
    mesh = tmesh.Mesh(2, 1, 1, "gloo", torch.device("cpu"), n_model=2)
    assert (mesh.data, mesh.pipe, mesh.model) == (0, 0, 1)
    assert mesh.shape == {"data": 1, "pipe": 2, "model": 2}
    assert mesh.describe()["transport"] == "gloo"
    fn = port.make_pipeline_grad_fn(cfg, sched, 2, device="cpu", mesh=mesh)
    whole = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shard_model"):
        fn(whole, torch.zeros(8, 6), torch.zeros(8, 6))


@pytest.mark.parametrize("arch,vp", [("ref", True), ("gpt2", False),
                                     ("llama", True)])
def test_shard_round_trip_and_jax_shards(arch, vp):
    """``shard_model`` / ``gather_model`` round-trip bitwise; the shards
    that ``from_jax_params(shard=)`` makes equal the addressable shards of
    JAX ``shard_params`` on a (model 2) mesh, bitwise."""
    jcfg = _jax_cfg(arch)
    tcfg = port.ModelConfig(**_port_fields(arch))
    tree = _numpy_tree(jcfg, 0)
    whole = port.from_jax_params(tcfg, tree, device="cpu")
    shards = [ttp.shard_model(whole, tcfg, n=2, index=j, vocab_parallel=vp)
              for j in range(2)]
    for j, sh in enumerate(shards):
        assert sh.tp_shard == ttp.TPShard(2, j, vp)
    for n, t in ttp.gather_model(shards, tcfg, vp).items():
        assert torch.equal(t, whole.state_dict()[n]), n
    jmesh = jtp.make_tp_mesh(n_model=2)
    placed = jtp.shard_params(jax.tree.map(jnp.asarray, tree), jcfg, jmesh)
    for j, dev in enumerate(jmesh.devices.reshape(-1)):
        local = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), placed)
        if not vp:  # JAX's param_specs always split the head over the vocab
            local["head"]["out"] = tree["head"]["out"]
        got = port.from_jax_params(tcfg, tree, device="cpu",
                                   shard=ttp.TPShard(2, j, vp))
        ref = _port_state(tcfg, local)
        for n, t in got.state_dict().items():
            assert torch.equal(t, ref[n]), (j, n)


def _port_state(cfg, tree):
    """The port's names over a (possibly sharded) JAX-layout tree, with
    no shape check: linear ``w`` transposed, layer leaves unstacked."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        weights)
    state = {"tok": tree["embed"]["tok"],
             "norm.weight": tree["head"]["norm"]["scale"]}
    if "pos" in tree["embed"]:
        state["pos"] = tree["embed"]["pos"]
    if "bias" in tree["head"]["norm"]:
        state["norm.bias"] = tree["head"]["norm"]["bias"]
    if "out" in tree["head"]:
        state["out.weight"] = np.asarray(tree["head"]["out"]["w"]).T
        if "b" in tree["head"]["out"]:
            state["out.bias"] = tree["head"]["out"]["b"]
    leaves = tree["layers"]
    for i in range(cfg.n_layers):
        for norm in weights._BLOCK_NORMS[cfg.arch]:
            state[f"layers.{i}.{norm}.weight"] = leaves[norm]["scale"][i]
            if "bias" in leaves[norm]:
                state[f"layers.{i}.{norm}.bias"] = leaves[norm]["bias"][i]
        for name, leaf in weights._linears(cfg, leaves).items():
            state[f"layers.{i}.{name}.weight"] = np.asarray(leaf["w"][i]).T
            if "b" in leaf:
                state[f"layers.{i}.{name}.bias"] = leaf["b"][i]
    return {k: torch.from_numpy(np.array(v))
            for k, v in state.items()}


WORLD = ["--model", "gpt2-small", "--layers", "4", "--dim", "32", "--heads",
         "2", "--vocab", "96", "--seq", "16", "--batch", "8", "--steps", "4",
         "--pipe", "2", "--tp", "2", "--vocab-parallel", "--tie-embeddings",
         "--microbatches", "2", "--device", "cpu", "--backend", "gloo",
         "--ckpt-every", "1", "--anomaly-guard", "--prefetch", "0"]


def test_train_tp_world_resumes_bitwise_after_a_kill(tmp_path):
    """``train.py --pipe 2 --tp 2 --vocab-parallel --backend gloo`` on the
    CPU: a world of 4 processes with a checkpoint a step, killed (the
    launcher's whole process group) once step 1 is committed, then
    resumed with ``--auto-resume``: every rank's file of its last
    checkpoint (its shard, its optimizer, guard and step) equals the
    unbroken run's bitwise. The world's checkpoint then loads whole into
    one process, equal to the shards, and decodes."""
    import signal
    import subprocess
    import sys

    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        train as tmain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        checkpoint as tcheckpoint, resilience as tresilience)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m",
           "distributed_training_with_pipeline_parallelism_tpu_torch.train",
           *WORLD]
    full, killed = str(tmp_path / "full"), str(tmp_path / "killed")
    runs = [subprocess.Popen(cmd + ["--ckpt", ck], cwd=root, env=env,
                             start_new_session=True, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for ck in (full, killed)]
    try:
        marker = os.path.join(killed, "step_1", "_COMMITTED.json")
        deadline = time.monotonic() + 120
        while not os.path.exists(marker) and runs[1].poll() is None:
            assert time.monotonic() < deadline, "step 1 never committed"
            time.sleep(0.05)
        os.killpg(runs[1].pid, signal.SIGKILL)
        runs[1].wait(timeout=30)
        out, _ = runs[0].communicate(timeout=120)
        assert runs[0].returncode == 0, out
    finally:
        for r in runs:
            if r.poll() is None:
                os.killpg(r.pid, signal.SIGKILL)
                r.wait()
    assert runs[1].returncode == -signal.SIGKILL
    assert "2 pipe x 2 model" in out and "final loss" in out
    assert not tcheckpoint.is_committed(os.path.join(killed, "step_3"))
    res = subprocess.run(cmd + ["--ckpt", killed, "--auto-resume"], cwd=root,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resumed from" in res.stdout
    names = sorted(os.listdir(os.path.join(full, "step_3")))
    assert names == ["_COMMITTED.json"] + [
        f"state_pipe{d}_model{m}.pt" for d in (0, 1) for m in (0, 1)]
    for name in names[1:]:
        a, b = (torch.load(os.path.join(ck, "step_3", name),
                           weights_only=True) for ck in (full, killed))
        assert a["step"] == b["step"] == 3
        flat_a = dict(tresilience._leaves(a))
        flat_b = dict(tresilience._leaves(b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, flat_b[k]), (name, k)
            else:
                assert v == flat_b[k], (name, k)

    # the whole model in one process: each shard's blocks, and it decodes
    args = tmain.parser().parse_args(WORLD)
    cfg = tmain.build_config(args)
    step3 = os.path.join(full, "step_3")
    state = tcheckpoint.restore_world_model(step3, cfg)
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(state)
    for name in names[1:]:
        d, m = int(name[10]), int(name[-4])
        part = torch.load(os.path.join(step3, name), weights_only=True)
        for k, v in part["model"].items():
            dim = ttp.split_dim(cfg, k, True)
            want = ttp.shard_tensor(state[k], dim, 2, m)
            assert torch.equal(v, want), (name, k)
    prompt = torch.randint(0, cfg.vocab_size, (2, 4),
                           generator=torch.Generator().manual_seed(2))
    out = port.generate(cfg, model, prompt, max_new_tokens=3,
                        temperature=0.0, device="cpu")
    assert out.shape == (2, 7) and torch.equal(out[:, :4], prompt)
    lockstep = ["--model", "gpt2-small", "--layers", "4", "--dim", "32",
                "--heads", "2", "--vocab", "96", "--seq", "16", "--batch",
                "8", "--tie-embeddings", "--steps", "1", "--pipe", "2",
                "--device", "cpu", "--prefetch", "0", "--resume", full]
    assert tmain.main(lockstep) == 0
