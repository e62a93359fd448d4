"""Strip the encoder from a checkpoint (port of ``tools/extract_decoder.py``;
reference ``MLIC++/submit/extract_model_state_dict.py``).

    python -m mlic_tpu_torch.tools.extract_decoder --checkpoint PATH \\
        --out decoder.pt

``--checkpoint`` is an orbax directory of the JAX package, a state_dict
file or a training checkpoint of the port (``weights.load_checkpoint``).
Writes a torch file of every leaf outside ``g_a`` and ``h_a``, which is
what ``mlic_tpu_torch.tools.decode`` needs.
"""

from __future__ import annotations

import argparse

import torch

from mlic_tpu_torch.weights import load_checkpoint

ENCODER_PREFIXES = ("g_a", "h_a")


def is_encoder(name: str) -> bool:
    """Whether a state_dict entry belongs to the encoder's transforms."""
    return name.split(".")[0] in ENCODER_PREFIXES


def strip_encoder(state: dict) -> dict:
    return {k: v for k, v in state.items() if not is_encoder(k)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="MLIC++ decoder-only weights")
    p.add_argument("--checkpoint", required=True,
                   help="orbax checkpoint directory or torch weights file")
    p.add_argument("--out", required=True, help="output torch file")
    args = p.parse_args(argv)
    state = load_checkpoint(args.checkpoint)
    kept = strip_encoder(state)
    torch.save(kept, args.out)
    print(f"wrote {len(kept)} of {len(state)} leaves to {args.out} "
          f"(dropped: {', '.join(ENCODER_PREFIXES)})")
    return kept


if __name__ == "__main__":
    main()
