"""The GPT-2 model, its configs and the KV-cache decoder."""
