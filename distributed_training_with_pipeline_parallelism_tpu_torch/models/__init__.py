"""The models: the reference, GPT-2 and llama decoders
(``transformer``), their registries (``gpt2``, ``llama``), Hugging Face
import and export (``hf``), the KV-cache decoder (``generate``) and the
Mixture-of-Experts LM (``moe``), whose experts split over a world's
expert axis."""

from .moe import MoEConfig, MoELM, moe_lm_loss

__all__ = ["MoEConfig", "MoELM", "moe_lm_loss"]
