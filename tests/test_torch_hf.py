"""The port's model sources against the JAX package's on the CPU: Hugging
Face import (``from_hf``) and export (``to_hf``, the state-dict
exporters), the tokenizer route (``encode_text_file_hf``) and the
``export_hf`` entry point.

Every HF model and tokenizer is built in memory from a tiny config (no
hub name, no download). Tolerances: the port's logits within 1e-4 of
HF's own forward and within 1e-5 of the JAX ``from_hf`` +
``transformer_apply`` on the same model; configs equal field by field;
round trips, exporters and token files bitwise; refusals in JAX's words.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from distributed_training_with_pipeline_parallelism_tpu.models import (  # noqa: E402
    hf as jhf, transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.models.generate import (  # noqa: E402
    generate as jgenerate)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (  # noqa: E402
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (  # noqa: E402
    make_pipeline_step)
from distributed_training_with_pipeline_parallelism_tpu.utils import (  # noqa: E402
    data as jdata)
import distributed_training_with_pipeline_parallelism_tpu as dtpp  # noqa: E402
import distributed_training_with_pipeline_parallelism_tpu_torch as port  # noqa: E402
from distributed_training_with_pipeline_parallelism_tpu_torch import (  # noqa: E402
    export_hf)
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (  # noqa: E402
    hf)
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (  # noqa: E402
    transformer_apply)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (  # noqa: E402
    data as tdata)

HF_TOL, JAX_TOL = 1e-4, 1e-5
V = 211
COMMON = dict(vocab_size=V, hidden_size=48, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64, rms_norm_eps=1e-6,
              rope_theta=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads beside the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(kind):
    """A tiny HF causal LM of each family the converters take."""
    if kind == "gpt2":
        c = transformers.GPT2Config(vocab_size=V, n_positions=64, n_embd=48,
                                    n_layer=2, n_head=4)
        cls = transformers.GPT2LMHeadModel
    elif kind in ("llama-gqa", "llama-mha", "llama3-rope"):
        kw = dict(num_key_value_heads=2 if kind != "llama-mha" else 4,
                  attention_bias=False, tie_word_embeddings=False)
        if kind == "llama3-rope":
            kw["rope_scaling"] = {
                "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0,
                "original_max_position_embeddings": 16}
        c = transformers.LlamaConfig(**COMMON, **kw)
        cls = transformers.LlamaForCausalLM
    elif kind == "mistral":
        c = transformers.MistralConfig(**COMMON, num_key_value_heads=2,
                                       sliding_window=5)
        cls = transformers.MistralForCausalLM
    elif kind == "qwen2":
        c = transformers.Qwen2Config(**COMMON, num_key_value_heads=2,
                                     tie_word_embeddings=True)
        cls = transformers.Qwen2ForCausalLM
    elif kind == "gemma":
        c = transformers.GemmaConfig(**COMMON, num_key_value_heads=1,
                                     head_dim=16,
                                     hidden_activation="gelu_pytorch_tanh")
        cls = transformers.GemmaForCausalLM
    torch.manual_seed(sum(map(ord, kind)))
    model = cls(c).eval()
    with torch.no_grad():  # norms off 1 and biases off 0, so a lost fold shows
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn_like(p))
    return model


KINDS = ["gpt2", "llama-gqa", "llama-mha", "llama3-rope", "mistral", "qwen2",
         "gemma"]


@pytest.fixture(scope="module")
def sources():
    return {k: _build(k) for k in KINDS}


def _tokens(seed, shape=(2, 17)):
    return np.random.default_rng(seed).integers(0, V, shape)


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).logits.numpy()


def _logits(cfg, model, tokens):
    with torch.no_grad():
        return transformer_apply(cfg, model, torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_from_hf_matches_hf_and_jax(sources, kind):
    """The imported model's logits against HF's forward (1e-4) and the JAX
    import's (1e-5) on 17 tokens (past Mistral's window of 5); the config
    equal to JAX's field by field."""
    src = sources[kind]
    cfg, model = hf.from_hf(src, device="cpu")
    jcfg, params = jhf.from_hf(src)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    tokens = _tokens(0)
    ours = _logits(cfg, model, tokens)
    np.testing.assert_allclose(ours, _hf_logits(src, tokens), atol=HF_TOL,
                               rtol=0)
    want = np.asarray(jtfm.transformer_apply(jcfg, params,
                                             jnp.asarray(tokens)))
    np.testing.assert_allclose(ours, want, atol=JAX_TOL, rtol=0)


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", KINDS)
def test_to_hf_round_trip_is_bitwise(sources, kind):
    """``from_hf(to_hf(model))`` gives the same weights bit for bit, and
    the exported model's logits are the port's (1e-4)."""
    cfg, model = hf.from_hf(sources[kind], device="cpu")
    out = hf.to_hf(cfg, model)
    assert out.config.model_type == sources[kind].config.model_type
    cfg2, model2 = hf.from_hf(out, device="cpu")
    assert cfg2 == cfg
    _same_state(model, model2)
    tokens = _tokens(1)
    np.testing.assert_allclose(_hf_logits(out, tokens),
                               _logits(cfg, model, tokens), atol=HF_TOL,
                               rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_exporters_match_jax_bitwise(sources, kind):
    """``gpt2_state_dict`` / ``llama_state_dict`` (Gemma's unfold
    included) give the JAX exporters' arrays bit for bit on the same
    imported weights."""
    src = sources[kind]
    cfg, model = hf.from_hf(src, device="cpu")
    jcfg, params = jhf.from_hf(src)
    if cfg.arch == "gpt2":
        got, want = hf.gpt2_state_dict(cfg, model), jhf.gpt2_state_dict(
            jcfg, params)
    else:
        off = 1.0 if cfg.embed_scale else 0.0
        got = hf.llama_state_dict(cfg, model, off)
        want = jhf.llama_state_dict(jcfg, params, off)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_state_dict_sources_dtype_and_device(sources):
    """The readers take a raw state dict (torch or numpy leaves, with or
    without the ``transformer.``/``model.`` prefix); bf16 storage casts
    once; the exporters copy (never a view of a parameter); ``from_hf``
    asks for CUDA unless told otherwise."""
    src = sources["gpt2"]
    cfg, model = hf.from_hf(src, device="cpu")
    bare = {k.removeprefix("transformer."): v.numpy()
            for k, v in src.state_dict().items()}
    _same_state(model, hf.gpt2_params_from_hf(bare, cfg, device="cpu"))
    bcfg, bmodel = hf.from_hf(src, dtype="bfloat16", device="cpu")
    assert bcfg.dtype == "bfloat16" and bmodel.tok.dtype == torch.bfloat16
    assert torch.equal(bmodel.tok, model.tok.to(torch.bfloat16))
    mixed = dataclasses.replace(bcfg, param_dtype="float32")
    assert hf.gpt2_params_from_hf(src, mixed, device="cpu").tok.dtype == \
        torch.float32
    sd = hf.gpt2_state_dict(cfg, model)
    sd["transformer.wte.weight"].zero_()
    assert model.tok.abs().sum() > 0
    gsrc = sources["gemma"]
    gcfg, gmodel = hf.from_hf(gsrc, device="cpu")
    # the (1 + w) fold, in float32: the HF weight plus one, exactly
    np.testing.assert_array_equal(
        gmodel.norm.weight.detach().numpy(),
        gsrc.model.norm.weight.detach().numpy() + np.float32(1.0))
    assert hf.llama_params_from_hf(
        {k.removeprefix("model."): v for k, v in gsrc.state_dict().items()},
        gcfg, 1.0, device="cpu").norm.weight.equal(gmodel.norm.weight)
    untied = dataclasses.replace(gcfg, tie_embeddings=False)
    assert torch.equal(hf.llama_params_from_hf(gsrc, untied, 1.0, "cpu")
                       .out.weight, gmodel.tok)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            hf.from_hf(src)


@pytest.mark.parametrize("kind", ["gpt2", "qwen2", "gemma"])
def test_greedy_generate_matches_hf(sources, kind):
    """The port's greedy ``generate`` on an imported model gives HF's
    tokens (and JAX's)."""
    src = sources[kind]
    cfg, model = hf.from_hf(src, device="cpu")
    prompt = _tokens(2, (2, 6))
    with torch.no_grad():
        want = src.generate(torch.from_numpy(prompt),
                            attention_mask=torch.ones(2, 6, dtype=torch.long),
                            max_new_tokens=8, do_sample=False,
                            pad_token_id=0).numpy()
    got = port.generate(cfg, model, prompt, 8, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    jcfg, params = jhf.from_hf(src)
    np.testing.assert_array_equal(
        got, np.asarray(jgenerate(jcfg, params, jnp.asarray(prompt), 8)))


def test_pipelined_step_on_imported_gemma_matches_jax(sources):
    """One 1F1B step at D = 2 on the imported Gemma (head_dim 16 over 4
    heads, one kv head, GeGLU, scaled embeddings, the folded norms): the
    loss and every gradient leaf within 1e-5 of the JAX pipeline step on
    the JAX import of the same model."""
    src = sources["gemma"]
    cfg, model = hf.from_hf(src, device="cpu")
    jcfg, params = jhf.from_hf(src)
    tokens, targets = _tokens(3, (4, 8)), _tokens(4, (4, 8))
    step = make_pipeline_step(jcfg, make_mesh(n_pipe=2),
                              dtpp.ScheduleConfig(name="1F1B",
                                                  n_microbatches=2))
    loss, grads = step(params, jnp.asarray(tokens), jnp.asarray(targets))
    got = port.make_pipeline_grad_fn(
        cfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu")(
            model, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(got.item() - float(loss)) <= JAX_TOL
    ref = port.from_jax_params(cfg, jax.tree.map(np.asarray, grads),
                               device="cpu")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref.get_parameter(name).detach().numpy(),
                                   atol=JAX_TOL, rtol=0, err_msg=name)


class _Cfg(dict):
    """An HF-config stand-in: the fields as attributes."""
    __getattr__ = dict.get


def _llama_fields(**kw):
    return _Cfg(dict(COMMON, num_key_value_heads=2, model_type="llama"),
                **kw)


@pytest.mark.parametrize("hf_cfg", [
    _llama_fields(rope_scaling={"rope_type": "yarn", "factor": 4.0}),
    _llama_fields(mlp_bias=True),
    _llama_fields(attention_bias=True),
    _llama_fields(model_type="qwen2", use_sliding_window=True,
                  sliding_window=8, max_window_layers=1),
], ids=["rope_yarn", "mlp_bias", "attention_bias", "qwen2_mixed_window"])
def test_llama_refusals_in_jax_words(hf_cfg):
    with pytest.raises(NotImplementedError) as want:
        jhf.llama_config_from_hf(hf_cfg)
    with pytest.raises(NotImplementedError) as got:
        hf.llama_config_from_hf(hf_cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model_type,act", [
    ("gemma", "gelu_new"), ("gemma2", "gelu"), ("gemma", None)])
def test_gemma_refusals_in_jax_words(model_type, act):
    hf_cfg = _llama_fields(model_type=model_type, head_dim=16,
                           hidden_activation=act)
    with pytest.raises(NotImplementedError) as want:
        jhf.gemma_config_from_hf(hf_cfg)
    with pytest.raises(NotImplementedError) as got:
        hf.gemma_config_from_hf(hf_cfg)
    assert str(got.value) == str(want.value)


def test_config_readers_take_namespaces():
    """``gemma_config_from_hf`` takes Gemma-1's historical 'gelu'; a
    Qwen2 config with its window off imports unwindowed; every reader
    reads any object with the fields, as JAX's does."""
    g = _llama_fields(model_type="gemma", head_dim=16, hidden_act="gelu",
                      num_key_value_heads=1)
    assert hf.gemma_config_from_hf(g) == jhf_port_cfg(
        jhf.gemma_config_from_hf(g))
    q = _llama_fields(model_type="qwen2", use_sliding_window=False,
                      sliding_window=8)
    cfg = hf.llama_config_from_hf(q)
    assert cfg.sliding_window is None and cfg.attention_qkv_bias
    assert hf.gpt2_config_from_hf(_Cfg(n_embd=48, n_layer=2, n_head=4,
                                       vocab_size=V, n_positions=64)) == \
        jhf_port_cfg(jhf.gpt2_config_from_hf(_Cfg(
            n_embd=48, n_layer=2, n_head=4, vocab_size=V, n_positions=64)))


def jhf_port_cfg(jcfg):
    """A JAX ``ModelConfig`` as the port's (the shared fields)."""
    return port.ModelConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(port.ModelConfig)})


@pytest.mark.parametrize("cfg,match", [
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64), "no HF equivalent"),
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64, arch="gpt2", embed_scale=True),
     "embed_scale on gpt2"),
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64, arch="llama", mlp_act="gelu"),
     "mlp_act='gelu' without embed_scale"),
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64, arch="llama", mlp_act="gelu",
                      embed_scale=True), "embed_scale exports as Gemma"),
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64, arch="llama", attention_qkv_bias=True,
                      rope_scaling=(8.0, 1.0, 4.0, 16)), "Qwen2Config"),
    (port.ModelConfig(dim=32, n_layers=1, n_heads=4, vocab_size=50,
                      ffn_dim=64, arch="llama", sliding_window=4,
                      rope_scaling=(8.0, 1.0, 4.0, 16)), "MistralConfig"),
], ids=["ref_decoder", "gpt2_embed_scale", "geglu_unscaled", "gemma_untied",
        "qwen2_rope_scaling", "mistral_rope_scaling"])
def test_to_hf_refusals_in_jax_words(cfg, match):
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    jcfg = dtpp.ModelConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})
    exc = ValueError if cfg.arch == "ref_decoder" else NotImplementedError
    with pytest.raises(exc) as want:  # JAX refuses before reading params
        jhf.to_hf(jcfg, None)
    with pytest.raises(exc, match=match) as got:
        hf.to_hf(cfg, model)
    assert str(got.value) == str(want.value)


def test_from_hf_refuses_unknown_model_type():
    src = _Cfg(config=_Cfg(model_type="falcon"))
    with pytest.raises(ValueError) as want:
        jhf.from_hf(src)
    with pytest.raises(ValueError) as got:
        hf.from_hf(src, device="cpu")
    assert str(got.value) == str(want.value)


# -- the tokenizer route -----------------------------------------------------


def _word_level():
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    t = Tokenizer(WordLevel({"hello": 0, "world": 1, "[UNK]": 2},
                            unk_token="[UNK]"))
    t.pre_tokenizer = Whitespace()
    return transformers.PreTrainedTokenizerFast(tokenizer_object=t,
                                                unk_token="[UNK]")


class _PairTok:
    """Per-word 2-character pairs: whitespace is a safe cut, a cut inside
    a word changes the ids (the straddling-token failure)."""

    def __len__(self):
        return 1 << 8

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [
            (ord(w[i]) * 7 + (ord(w[i + 1]) if i + 1 < len(w) else 31)) % 251
            for w in text.split() for i in range(0, len(w), 2)]}


class _BigTok:
    """A vocabulary past 2^16: uint32 ids."""

    def __len__(self):
        return 1 << 17

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [65536 + ord(c) % 1000 for c in text
                              if not c.isspace()]}


@pytest.mark.parametrize("case", ["word_level", "whitespace_free", "uint32"])
def test_encode_text_file_hf_writes_jax_bytes(tmp_path, case):
    """Token file and sidecar byte for byte the JAX function's, one-shot
    and chunked, for the same tokenizer object and text; a stale uint32
    sidecar goes when the path is re-encoded with a small vocabulary."""
    tok, text = {
        "word_level": (_word_level(), "hello world hello hello unknown\n" * 3),
        "whitespace_free": (_PairTok(), "x" + "ab" * 50 + " tail words here"),
        "uint32": (_BigTok(), "ab cd ef gh ij kl mn op qr st uv wx yz 01 23"),
    }[case]
    src = tmp_path / "corpus.txt"
    src.write_text(text)
    for chunk in (1 << 20, 7):
        outs = {}
        for side, mod in (("jax", jdata), ("port", tdata)):
            out = tmp_path / f"{side}.bin"
            n = mod.encode_text_file_hf(str(src), str(out), tokenizer=tok,
                                        chunk_chars=chunk)
            meta = tmp_path / f"{side}.bin.meta.json"
            outs[side] = (n, out.read_bytes(),
                          meta.read_text() if meta.exists() else None)
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] > 0
    n, data, meta = outs["port"]
    if case == "uint32":
        assert json.loads(meta) == {"dtype": "uint32", "vocab_size": 1 << 17}
        ds = tdata.TokenFileDataset(str(tmp_path / "port.bin"), 8)
        assert len(ds) == n and int(ds.sample(2)[0].min()) >= 65536
        tdata.encode_text_file_hf(str(src), str(tmp_path / "port.bin"),
                                  tokenizer=_PairTok())
        assert not (tmp_path / "port.bin.meta.json").exists()
    else:
        assert meta is None and len(data) == 2 * n


# -- export_hf ---------------------------------------------------------------


def test_export_hf_turns_a_fit_checkpoint_into_hf(tmp_path):
    """``fit`` trains a tied GPT-2 for 2 steps with a checkpoint; the
    entry point exports the checkpoint dir, and the saved directory's HF
    logits are the trained model's."""
    cfg = port.gpt2_config("small", dim=32, n_layers=2, n_heads=2,
                           vocab_size=97, ffn_dim=128, tie_embeddings=True)
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    data = tdata.synthetic_batches(97, 4, 16, seed=1)
    ckpt = tmp_path / "ckpt"
    port.fit(cfg, port.ScheduleConfig("1F1B", 2), 2, model, data, 2,
             checkpoint_dir=str(ckpt), checkpoint_every=2, verbose=False,
             device="cpu")
    out = tmp_path / "hf"
    assert export_hf.main(["--model", "gpt2-small", "--dim", "32",
                           "--layers", "2", "--heads", "2", "--vocab", "97",
                           "--ckpt", str(ckpt), "--out", str(out),
                           "--device", "cpu"]) == 0
    saved = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    assert saved.config.tie_word_embeddings and saved.config.n_inner == 128
    tokens = _tokens(5, (2, 16)) % 97
    np.testing.assert_allclose(_hf_logits(saved, tokens),
                               _logits(cfg, model, tokens), atol=HF_TOL,
                               rtol=0)
    with pytest.raises(SystemExit, match="no HF equivalent"):
        export_hf.main(["--model", "ref", "--ckpt", str(ckpt), "--out",
                        str(out)])
    with pytest.raises(SystemExit, match="not a checkpoint"):
        export_hf.main(["--model", "gpt2-small", "--ckpt", str(tmp_path),
                        "--out", str(out), "--device", "cpu"])


# -- the card's HF-named sources (chip_smoke.py phase 18) --------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_HF_CLASSES = {"gpt2": ("GPT2Config", "GPT2LMHeadModel"),
               "gemma-2b": ("GemmaConfig", "GemmaForCausalLM"),
               "qwen2-0.5b": ("Qwen2Config", "Qwen2ForCausalLM")}
_TINY = {"gpt2": dict(vocab_size=97, n_positions=32, n_embd=32, n_layer=2,
                      n_head=2),
         "gemma-2b": dict(vocab_size=97, hidden_size=32,
                          intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=8, head_dim=8,
                          max_position_embeddings=64),
         "qwen2-0.5b": dict(vocab_size=97, hidden_size=28,
                            intermediate_size=48, num_hidden_layers=2,
                            max_position_embeddings=64, sliding_window=64,
                            max_window_layers=2)}


@pytest.mark.parametrize("name", sorted(_HF_CLASSES))
def test_chip_smoke_sources_are_hf_layouts(name):
    """The card's stand-ins for three published checkpoints hold what
    transformers would: the published fields read by the transformers
    config class give ``from_hf`` the same config as the namespace does,
    and the registry's but for max_seq_len; at a tiny width the layout
    ``hf_layout`` promises (checked on the card against the exporter's
    tensors) is the HF class's own state dict, and the port's exporter
    writes it."""
    cs = _chip_smoke()
    conf_cls, model_cls = (getattr(transformers, n)
                           for n in _HF_CLASSES[name])
    fields = {k: v for k, v in cs.HF_CONFIGS[name].items()
              if k != "model_type"}
    convert = hf._CONVERTERS[cs.HF_CONFIGS[name]["model_type"]][0]
    from_ns = convert(cs.HFSource(name, {}).config)
    assert convert(conf_cls(**fields)) == from_ns
    reg = cs.hf_registry(name)
    for f in dataclasses.fields(reg):
        if f.name != "max_seq_len":
            assert getattr(from_ns, f.name) == getattr(reg, f.name), f.name
    tiny = cs.HFSource(name, {}, **_TINY[name]).config
    model = model_cls(conf_cls(**dict(fields, **_TINY[name])))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if k != "lm_head.weight"}
    assert cs.hf_layout(tiny) == want
    cfg, ours = hf.from_hf(model, device="cpu")
    got = (hf.gpt2_state_dict(cfg, ours) if cfg.arch == "gpt2" else
           hf.llama_state_dict(cfg, ours, 1.0 if cfg.embed_scale else 0.0))
    assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_transformers_imported_only_where_needed():
    """The port imports ``transformers`` only inside ``to_hf`` and
    ``encode_text_file_hf`` (its name route), never at a module's top;
    ``chip_smoke.py`` imports neither ``transformers`` nor ``tokenizers``
    (the card's host is not promised them)."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    where = set()

    def visit(node, path, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        if any(n.split(".")[0] in ("transformers", "tokenizers")
               for n in names):
            where.add((path.name, fn))
        for child in ast.iter_child_nodes(node):
            visit(child, path, fn)

    for path in sorted((root / port.__name__).rglob("*.py")) + [
            root / "chip_smoke.py"]:
        visit(ast.parse(path.read_text()), path, None)
    assert where == {("hf.py", "to_hf"), ("data.py", "encode_text_file_hf")}
