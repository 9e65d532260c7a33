"""Export a checkpoint of the port to a Hugging Face ``save_pretrained``
directory (the port's counterpart of the JAX package's
``scripts/export_hf.py``):

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.export_hf \\
        --model gpt2-small --ckpt /tmp/ckpt --out /tmp/hf_model

``--ckpt`` is a ``fit`` checkpoint directory (its newest committed
``step_N`` is read) or one ``step_N`` directory, written by one process or
by a world (its files merged whole, ``utils.checkpoint.restore_world_model``).
``--model`` and the width overrides are ``train.py``'s: ``--dim`` without
``--ffn`` keeps the family's FFN:dim ratio, as training did. A checkpoint
with no ``out.weight`` was trained tied and exports tied. The directory
loads with ``transformers.AutoModelForCausalLM.from_pretrained``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True,
                    help="gpt2-{small,medium,large,xl} or a llama-family "
                         "name of models/llama.py (llama3.2-1b, "
                         "mistral-7b-v0.1, qwen2-0.5b, gemma-2b, ...)")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dim", type=int, default=0)
    ap.add_argument("--ffn", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the port's model is rebuilt (cpu for a "
                         "host without a card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.model == "ref":
        raise SystemExit("ref_decoder has no HF equivalent (the reference's "
                         "block is not a public architecture)")
    from . import train
    from .models.hf import to_hf
    from .models.transformer import Transformer
    from .utils.checkpoint import restore_world_model
    from .utils.config import resolve_device
    from .utils.train import _latest_step_dir

    widths = [f"--{k}={getattr(args, k)}"
              for k in ("dim", "ffn", "layers", "heads", "vocab")
              if getattr(args, k)]
    cfg = train.build_config(train.parser().parse_args(
        ["--model", args.model, *widths]))
    path = args.ckpt
    latest = _latest_step_dir(path)
    if latest is not None:
        path = latest[1]
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        raise SystemExit(f"--ckpt {path}: not a checkpoint of this package "
                         f"(a fit checkpoint dir or one of its step_N dirs)")
    state = restore_world_model(path, cfg)
    cfg = dataclasses.replace(cfg, tie_embeddings="out.weight" not in state)
    model = Transformer(cfg, device=resolve_device(args.device))
    model.load_state_dict(state)
    print(f"loaded {path}", flush=True)
    hf = to_hf(cfg, model)
    hf.save_pretrained(args.out)
    print(f"exported {args.model} -> {args.out} "
          f"({hf.num_parameters():,} params)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
