"""FSDP (ZeRO-3) in the port's ``torch.distributed`` world on the CPU, held
to the JAX package's ``parallel/fsdp.py`` and pp x fsdp executor.

One gloo world of 4 ranks (``parallel.selftest.run_cases`` under
``parallel.mesh.launch``, so the children import neither jax nor this
module) runs every case on a thread, while the JAX references compile
here on the simulated 8-device mesh:

- (a) ``fsdp_specs`` and ``fsdp_shard_dims`` pick, leaf by leaf, the JAX
  ``fsdp_specs`` / ``_fsdp_shard_dims`` dim under the layout mapping
  (exact; T = 1 and T = 2), checked by loading a JAX tree whose leaves
  vary along the JAX pick only through ``from_jax_params``.
- (b) ``make_fsdp_grad_fn`` on a data-only world of 4 against the JAX
  ``make_fsdp_grad_fn`` (``tests/test_fsdp.py:13-28``'s bounds: loss
  1e-5, gradients 2e-5); the gradients come back at the shards' shapes,
  each the JAX shard transposed.
- (c) pp x fsdp (pipe 2 x data 2) under GPipe, 1F1B, Interleaved1F1B and
  ZBH1, and its forward-only eval: within 2e-5 of the JAX
  ``make_pipeline_step(fsdp=True)`` (1F1B) and of ``jax.value_and_grad``
  of ``transformer_loss`` (the oracle JAX holds that step to at the same
  2e-5); each rank's layer matrices and their gradients hold 1/2 of its
  stage's elements.
- (d) ``fit(fsdp=True)`` with SGD for 4 steps equals the replicated run
  within 1e-5 (``tests/test_fsdp.py:183-216``); killed in a save and
  resumed, it ends bitwise where the unbroken run does, and the step dir
  loads whole into one process.

Sizes are the JAX tests': gpt2, dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 8, seq 8, weights and batches from numpy with a seed.
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

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    fsdp as jfsdp)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    pipeline as jpipe)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    fsdp as tfsdp, mesh as tmesh, selftest)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    train as ttrain)
from test_torch_tp import _numpy_tree
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S = 8, 8
TOL = 2e-5
PP = (("GPipe", 1, 2), ("1F1B", 1, 2), ("Interleaved1F1B", 2, 2),
      ("ZBH1", 1, 2))


def _port_cfg():
    return port.ModelConfig(**BASE, use_flash_attention=True,
                            use_fused_xent=True)


def _jax_cfg():
    return dtpp.ModelConfig(**BASE)


def _batch():
    rng = np.random.default_rng(1)
    return tuple(rng.integers(0, BASE["vocab_size"], (B, S)) for _ in range(2))


def _cases():
    common = dict(cfg="gpt2", tree="gpt2", fsdp=True, comm_overlap="none")
    cases = [dict(name=f"pp_{s}", kind="grad", schedule=s, n_virtual=V, M=M,
                  n_pipe=2, n_data=2, **common) for s, V, M in PP]
    cases += [
        dict(name="eval", kind="eval", schedule="GPipe", M=2, n_pipe=2,
             n_data=2, **common),
        dict(name="grad_fn", kind="fsdp_grad_fn", cfg="gpt2", tree="gpt2",
             schedule="GPipe", M=1, n_pipe=1, n_data=4),
        dict(name="fit", kind="fsdp_fit", cfg="gpt2", tree="gpt2",
             schedule="GPipe", M=2, n_pipe=2, n_data=2, steps=4, kill=2,
             B=B, S=S)]
    return cases


class _World:
    """The world's run in a thread of this process, joined on first use."""

    def __init__(self, out):
        self.out = out
        batch = _batch()
        self.spec = dict(cfg={}, cfgs={"gpt2": dataclasses.asdict(
            _port_cfg())}, trees={"gpt2": _numpy_tree(_jax_cfg(), 0)},
            tokens=batch[0], targets=batch[1], out=str(out), threads=1,
            cases=_cases())
        self._box = {}
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        try:
            t = time.perf_counter()
            self._box["ranks"] = tmesh.launch(
                selftest.run_cases, port.MeshConfig(2, 2), self.spec,
                backend="gloo", device="cpu", timeout_s=120)
            self._box["seconds"] = time.perf_counter() - t
        except BaseException as e:  # re-raised on the test's thread
            self._box["error"] = e

    def result(self):
        self._thread.join(timeout=300)
        assert not self._thread.is_alive(), "the world did not finish"
        if "error" in self._box:
            raise self._box["error"]
        return self._box

    def rank(self, name, r):
        return dict(np.load(os.path.join(self.out, f"{name}_r{r}.npz")))

    def merged(self, name, n_pipe, n_data):
        """(loss, whole gradients, shards) of a case: each pipe rank's
        data shards concatenated along their dims, a replicated leaf equal
        on every data rank, every rank's loss the same."""
        mesh = tmesh.Mesh(n_pipe, n_data, 0, "gloo", torch.device("cpu"))
        losses, whole, shards = set(), {}, {}
        for p in range(n_pipe):
            zs = [self.rank(name, mesh.rank_of(k, p)) for k in range(n_data)]
            losses.update(float(z["loss"]) for z in zs)
            dims = {n[5:]: int(d) for n, d in zs[0].items()
                    if n.startswith("fsdp/")}
            for n in (n for n in zs[0] if n.startswith("grad/")):
                leaf = n[5:]
                parts = [torch.from_numpy(z[n]) for z in zs]
                shards[leaf] = parts[0]
                if leaf in dims:
                    whole[leaf] = torch.cat(parts, dim=dims[leaf])
                else:
                    for other in parts[1:]:
                        assert torch.equal(parts[0], other), (name, leaf)
                    whole[leaf] = parts[0]
        assert len(losses) == 1, (name, losses)
        return losses.pop(), whole, shards


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(tmp_path_factory.mktemp("fsdp"))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references: ``value_and_grad`` of ``transformer_loss``, the
    pp x fsdp step (1F1B) and ``make_fsdp_grad_fn`` on 4 devices."""
    jcfg = _jax_cfg()
    params = jax.tree.map(jnp.asarray, _numpy_tree(jcfg, 0))
    tokens, targets = _batch()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(params)
    mesh = jax_make_mesh(n_pipe=2, n_data=2)
    step = jpipe.make_pipeline_step(jcfg, mesh, dtpp.ScheduleConfig("1F1B", 2),
                                    fsdp=True)
    sloss, sgrads = step(jpipe.fsdp_shard_params(params, jcfg, mesh), tokens,
                         targets)
    fmesh = jfsdp.make_fsdp_mesh(4)
    floss, fgrads = jfsdp.make_fsdp_grad_fn(jcfg, fmesh, params)(
        jfsdp.shard_params_fsdp(params, fmesh), tokens, targets)
    shard_shapes = jax.tree.map(
        lambda x: {s.data.shape for s in x.addressable_shards}, fgrads)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"oracle": (float(loss), np_tree(grads)),
            "pp_1F1B": (float(sloss), np_tree(sgrads)),
            "grad_fn": (float(floss), np_tree(fgrads)),
            "grad_fn_shards": shard_shapes}


def _check(name, loss, grads, jloss, jgrads, loss_tol=TOL):
    assert abs(loss - jloss) < loss_tol, (name, loss, jloss)
    ref = port.from_jax_params(_port_cfg(), jgrads, device="cpu")
    assert set(grads) == {n for n, _ in ref.named_parameters()}, name
    worst = max(float((grads[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < TOL, (name, worst)


def _dim_tree(shapes, pick):
    """A JAX tree whose leaf varies along ``pick(path, leaf)`` only (an
    arange there, broadcast), or is zero where it returns None or -1."""
    def leaf(path, s):
        d = pick(path, s)
        if d is None or d < 0:
            return np.zeros(s.shape, np.float32)
        shape = [1] * len(s.shape)
        shape[d] = s.shape[d]
        return np.broadcast_to(np.arange(s.shape[d], dtype=np.float32)
                               .reshape(shape), s.shape).copy()
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _varying_dim(t):
    dims = [i for i in range(t.ndim) if t.shape[i] > 1
            and bool((t.diff(dim=i) != 0).any())]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.mark.parametrize("arch,kw", [("gpt2", {}), ("ref_decoder", {}),
                                     ("llama", dict(n_kv_heads=2))])
def test_fsdp_specs_match_jax(arch, kw):
    """(a) The data-only rule on every leaf (4 shards), through the
    layout mapping."""
    jcfg = dtpp.ModelConfig(**dict(BASE, arch=arch, **kw))
    tcfg = port.ModelConfig(**dict(BASE, arch=arch, **kw))
    shapes = jax.eval_shape(lambda: jtfm.transformer_init(jax.random.key(0),
                                                          jcfg))
    specs = jfsdp.fsdp_specs(shapes, 4)
    flat = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}

    def pick(path, s):
        spec = tuple(flat[jax.tree_util.keystr(path)])
        return spec.index("data") if "data" in spec else None

    model = port.from_jax_params(tcfg, _dim_tree(shapes, pick), device="cpu")
    got = tfsdp.fsdp_specs(model, 4)
    want = {n: _varying_dim(p.detach()) for n, p in model.named_parameters()}
    assert got == want
    assert any(d is not None for d in got.values())


@pytest.mark.parametrize("arch,T", [("gpt2", 1), ("gpt2", 2),
                                    ("llama", 1), ("llama", 2),
                                    ("ref_decoder", 1), ("ref_decoder", 2)])
def test_pipeline_fsdp_dims_match_jax(arch, T):
    """(a) The pipeline's rule: the blocks' matrices only, never on the
    Megatron dim under T = 2."""
    kw = dict(n_kv_heads=2) if arch == "llama" else {}
    jcfg = dtpp.ModelConfig(**dict(BASE, arch=arch, **kw))
    tcfg = port.ModelConfig(**dict(BASE, arch=arch, **kw))
    dims = jpipe._fsdp_shard_dims(jcfg, 2, T)
    flat = {jax.tree_util.keystr(p): d for p, d in
            jax.tree_util.tree_flatten_with_path(dims)[0]}
    shapes = jax.eval_shape(lambda: jtfm.transformer_init(jax.random.key(0),
                                                          jcfg))

    def pick(path, s):
        key = jax.tree_util.keystr(path)
        if not key.startswith("['layers']"):
            return None
        return flat[key[len("['layers']"):]]

    model = port.from_jax_params(tcfg, _dim_tree(shapes, pick), device="cpu")
    got = tfsdp.fsdp_shard_dims(tcfg, 2, T)
    for n, p in model.named_parameters():
        want = _varying_dim(p.detach())
        if n.startswith("layers."):
            assert got[n.split(".", 2)[2]] == want, n
        else:
            assert want is None, n
    if T > 1:
        from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
            tensor_parallel as ttp)
        for leaf, d in got.items():
            assert d is None or d != ttp.split_dim(tcfg, f"layers.0.{leaf}")


def test_fsdp_grad_fn_matches_jax(world, jax_refs):
    """(b) The data-only FSDP gradient on 4 ranks against JAX's; the
    gradients come back at the shards' shapes (the JAX shards
    transposed)."""
    world.result()
    loss, grads, shards = world.merged("grad_fn", 1, 4)
    _check("grad_fn", loss, grads, *jax_refs["grad_fn"], loss_tol=1e-5)
    jshapes = jax_refs["grad_fn_shards"]
    tcfg = _port_cfg()
    # one leaf of each layout: a linear weight (transposed), the table
    want = {"layers.0.lin1.weight": next(iter(
        jshapes["layers"]["lin1"]["w"]))[1:][::-1],
        "tok": next(iter(jshapes["embed"]["tok"]))}
    for n, shape in want.items():
        assert tuple(shards[n].shape) == tuple(shape), n
    spec = tfsdp.fsdp_specs(port.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"), 4)
    for n, g in grads.items():
        if spec[n] is not None:
            assert shards[n].shape[spec[n]] * 4 == g.shape[spec[n]], n


@pytest.mark.parametrize("schedule", [s for s, _, _ in PP])
def test_pp_fsdp_matches_jax(world, jax_refs, schedule):
    """(c) pp x fsdp under each schedule; layer matrices and their
    gradients rest at 1/2 of the stage's elements on every rank."""
    world.result()
    name = f"pp_{schedule}"
    loss, grads, shards = world.merged(name, 2, 2)
    ref = jax_refs["pp_1F1B" if schedule == "1F1B" else "oracle"]
    _check(name, loss, grads, *ref)
    cfg = _port_cfg()
    for r in range(4):
        z = world.rank(name, r)
        mats = [n[5:] for n in z if n.startswith("grad/layers.")
                and z[n].ndim == 2]
        held = sum(z[f"grad/{n}"].size for n in mats)
        full = sum(grads[n].numel() for n in mats)
        assert mats and 2 * held == full, (name, r, held, full)
        dims = tfsdp.fsdp_shard_dims(cfg, 2)
        assert {n[5:] for n in z if n.startswith("fsdp/")} == {
            n for n in mats if dims[n.split(".", 2)[2]] is not None}


def test_pp_fsdp_eval_matches_jax(world, jax_refs):
    """(c) The forward-only eval on the same shards (the JAX eval's
    just-in-time chunk gathers)."""
    world.result()
    losses = {float(world.rank("eval", r)["loss"]) for r in range(4)}
    assert len(losses) == 1
    assert abs(losses.pop() - jax_refs["oracle"][0]) < TOL
    assert abs(float(world.rank("eval", 0)["lockstep"])
               - jax_refs["oracle"][0]) < TOL


def test_fit_fsdp_matches_replicated_and_resumes(world):
    """(d) ``fit(fsdp=True)`` with SGD against the replicated run, the
    killed-and-resumed run bitwise, the step dir loadable whole."""
    world.result()
    cfg = _port_cfg()
    dims = tfsdp.fsdp_shard_dims(cfg, 2)
    mesh = tmesh.Mesh(2, 2, 0, "gloo", torch.device("cpu"))
    whole = {k[6:]: v for k, v in world.rank("fit", 0).items()
             if k.startswith("whole/")}
    for p in range(2):
        zs = [world.rank("fit", mesh.rank_of(k, p)) for k in range(2)]
        for k, z in enumerate(zs):
            for n in (n for n in z if n.startswith("fsdp/param/")):
                np.testing.assert_array_equal(
                    z[n], z["resumed" + n[4:]], err_msg=n)
        for n in (n[len("replicated/param/"):] for n in zs[0]
                  if n.startswith("replicated/param/")):
            d = dims.get(n.split(".", 2)[2]) if n.startswith("layers.") \
                else None
            parts = [z[f"fsdp/param/{n}"] for z in zs]
            got = parts[0] if d is None else np.concatenate(parts, axis=d)
            np.testing.assert_allclose(got, zs[0][f"replicated/param/{n}"],
                                       rtol=0, atol=1e-5, err_msg=n)
            np.testing.assert_array_equal(got, whole[n], err_msg=n)
    assert np.isfinite(list(whole.values())[0]).all()


@pytest.mark.parametrize("kw,match", [
    (dict(fsdp=True), "needs a 'data' mesh axis"),
    (dict(fsdp=True, remat_backward=False, data=2),
     "remat_backward=False is incompatible with fsdp"),
    (dict(fsdp=True, dynamics=True, data=2), "unsupported here: fsdp"),
    (dict(fsdp=True, data=2, whole=True), "fsdp_shard_params"),
])
def test_pp_fsdp_refusals(kw, match):
    """(h) The JAX ``make_pipeline_grad_fn``'s fsdp refusals, word for
    word, and a whole model handed to the sharded step."""
    cfg = _port_cfg()
    kw = dict(kw)
    n_data = kw.pop("data", 1)
    whole = kw.pop("whole", False)
    mesh = tmesh.Mesh(2, n_data, 0, "gloo", torch.device("cpu"))
    sched = port.ScheduleConfig("1F1B", 2)
    with pytest.raises(ValueError, match=match):
        fn = port.make_pipeline_grad_fn(cfg, sched, 2, device="cpu",
                                        mesh=mesh if n_data > 1 else None,
                                        **kw)
        assert whole
        model = port.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        fn(model, *_batch())


def test_fsdp_shard_and_gather_round_trip():
    """``fsdp_shard_params`` and ``gather_fsdp`` are inverses, on a
    Megatron shard too (the data dim never the model dim); a leaf the JAX
    rule would shard on its stacked layer axis is refused."""
    cfg = _port_cfg()
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for T in (1, 2):
        base = port.shard_model(model, cfg, n=T, index=1) if T > 1 else model
        shards = [tfsdp.fsdp_shard_params(base, cfg, n=2, index=k)
                  for k in range(2)]
        assert tfsdp.fsdp_shard_of(shards[1]).index == 1
        back = tfsdp.gather_fsdp(shards)
        for n, t in base.state_dict().items():
            assert torch.equal(back[n], t), n
    tiny = port.ModelConfig(**dict(BASE, dim=6, n_heads=2, ffn_dim=6,
                                   vocab_size=6, max_seq_len=6))
    with pytest.raises(ValueError, match="stacked layer axis"):
        tfsdp.fsdp_specs(port.init_params(
            tiny, torch.Generator().manual_seed(0), device="cpu"), 4)
    with pytest.raises(ValueError, match="'data' mesh axis"):
        tfsdp.fsdp_shard_params(model, cfg, n=1, index=0)
    assert ttrain.sgd(0.1).learning_rate == 0.1
