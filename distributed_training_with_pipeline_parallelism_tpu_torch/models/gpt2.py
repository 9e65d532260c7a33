"""GPT-2 family configurations (a copy of the JAX package's
``models/gpt2.py:gpt2_config``)."""

from __future__ import annotations

from ..utils.config import ModelConfig


def gpt2_config(name: str = "small", **overrides) -> ModelConfig:
    sizes = {
        "small": dict(dim=768, n_layers=12, n_heads=12),     # 124M
        "medium": dict(dim=1024, n_layers=24, n_heads=16),   # 350M
        "large": dict(dim=1280, n_layers=36, n_heads=20),    # 774M
        "xl": dict(dim=1600, n_layers=48, n_heads=25),       # 1.5B
    }
    if name not in sizes:
        raise ValueError(f"unknown GPT-2 size {name!r}; options: {sorted(sizes)}")
    base = sizes[name]
    kw = dict(vocab_size=50257, ffn_dim=4 * base["dim"], max_seq_len=1024,
              arch="gpt2", **base)
    kw.update(overrides)
    return ModelConfig(**kw)
