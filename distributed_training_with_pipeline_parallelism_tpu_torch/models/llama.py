"""Llama family configurations (a copy of the JAX package's
``models/llama.py:llama_config``, every entry): Llama-2/3/3.1/3.2,
Mistral, Qwen2, Gemma and the scaled-down ``llama-debug``."""

from __future__ import annotations

from ..utils.config import ModelConfig


def llama_config(name: str = "llama2-7b", **overrides) -> ModelConfig:
    sizes = {
        # dim, layers, heads, kv_heads, ffn, vocab, rope_theta
        "llama2-7b": dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                          ffn_dim=11008, vocab_size=32000, rope_theta=1e4),
        "llama2-13b": dict(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                           ffn_dim=13824, vocab_size=32000, rope_theta=1e4),
        "llama3-8b": dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                          ffn_dim=14336, vocab_size=128256, rope_theta=5e5),
        # 3.1: same shape, 128k context via llama3 rope frequency scaling
        "llama3.1-8b": dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                            ffn_dim=14336, vocab_size=128256, rope_theta=5e5,
                            max_seq_len=131072,
                            rope_scaling=(8.0, 1.0, 4.0, 8192)),
        # Mistral v0.1: llama blocks + 4096-token sliding-window attention
        "mistral-7b-v0.1": dict(dim=4096, n_layers=32, n_heads=32,
                                n_kv_heads=8, ffn_dim=14336, vocab_size=32000,
                                rope_theta=1e4, max_seq_len=32768,
                                sliding_window=4096),
        # Mistral v0.3: full attention, 1e6 theta, extended vocab
        "mistral-7b-v0.3": dict(dim=4096, n_layers=32, n_heads=32,
                                n_kv_heads=8, ffn_dim=14336, vocab_size=32768,
                                rope_theta=1e6, max_seq_len=32768),
        # 3.2 small models: llama3 blocks, TIED embeddings, rope scaling
        "llama3.2-1b": dict(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                            ffn_dim=8192, vocab_size=128256, rope_theta=5e5,
                            max_seq_len=131072, tie_embeddings=True,
                            rope_scaling=(32.0, 1.0, 4.0, 8192)),
        "llama3.2-3b": dict(dim=3072, n_layers=28, n_heads=24, n_kv_heads=8,
                            ffn_dim=8192, vocab_size=128256, rope_theta=5e5,
                            max_seq_len=131072, tie_embeddings=True,
                            rope_scaling=(32.0, 1.0, 4.0, 8192)),
        # Qwen2: llama blocks + q/k/v biases; 0.5B ties its embeddings
        "qwen2-0.5b": dict(dim=896, n_layers=24, n_heads=14, n_kv_heads=2,
                           ffn_dim=4864, vocab_size=151936, rope_theta=1e6,
                           max_seq_len=32768, attention_qkv_bias=True,
                           tie_embeddings=True, rms_eps=1e-6),
        "qwen2-7b": dict(dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
                         ffn_dim=18944, vocab_size=152064, rope_theta=1e6,
                         max_seq_len=32768, attention_qkv_bias=True,
                         rms_eps=1e-6),
        # Gemma 1: decoupled head_dim 256, GeGLU, scaled embeddings, tied,
        # (1+w) norms folded at HF conversion; 2b is multi-query (kv=1)
        "gemma-2b": dict(dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
                         head_dim_override=256, ffn_dim=16384,
                         vocab_size=256000, rope_theta=1e4, max_seq_len=8192,
                         mlp_act="gelu", embed_scale=True,
                         tie_embeddings=True, rms_eps=1e-6),
        "gemma-7b": dict(dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
                         head_dim_override=256, ffn_dim=24576,
                         vocab_size=256000, rope_theta=1e4, max_seq_len=8192,
                         mlp_act="gelu", embed_scale=True,
                         tie_embeddings=True, rms_eps=1e-6),
        # scaled-down variant with the same shape ratios for tests/benches
        "llama-debug": dict(dim=256, n_layers=8, n_heads=8, n_kv_heads=4,
                            ffn_dim=688, vocab_size=1024, rope_theta=1e4),
    }
    if name not in sizes:
        raise ValueError(f"unknown Llama size {name!r}; options: {sorted(sizes)}")
    kw = dict(max_seq_len=4096, arch="llama", rms_eps=1e-5)
    kw.update(sizes[name])
    kw.update(overrides)
    return ModelConfig(**kw)
