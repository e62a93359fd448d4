"""Reduce a training checkpoint to its weights (port of
``tools/make_bench_ckpt.py``).

    python -m mlic_tpu_torch.tools.make_bench_ckpt \\
        runs/train/mlic_tpu_torch/checkpoint_20000.pt bench.pt [--bf16]

The source is a training checkpoint of the port
(``utils.checkpoint.CheckpointManager``'s ``checkpoint_<tag>.pt``: model,
optimizers, step), an orbax directory of the JAX package (read by
``utils.checkpoint.read_orbax``) or a state_dict file; the output is a
torch file of the model's weights alone, which ``weights.load_checkpoint``
reads.  ``--bf16`` stores them as bfloat16 (half the bytes; MLICPP_L is
334 MB in f32): ``load_checkpoint`` widens them back to f32, the same
values on every load.  A host tool: no device work.
"""

from __future__ import annotations

import argparse

import torch

from mlic_tpu_torch.weights import load_checkpoint


def make(src: str, dst: str, bf16: bool = False) -> dict:
    """Write ``src``'s weights to ``dst`` (bfloat16 where ``bf16``);
    returns the state_dict written."""
    state = load_checkpoint(src)
    if bf16:
        state = {k: v.to(torch.bfloat16) for k, v in state.items()}
    torch.save(state, dst)
    n = sum(v.numel() for v in state.values())
    print(f"wrote {dst}: {len(state)} tensors, {n / 1e6:.2f} M params"
          + (" (bfloat16 storage)" if bf16 else ""))
    return state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="training checkpoint (.pt), orbax directory "
                               "or state_dict file")
    p.add_argument("dst", nargs="?", default="ckpts/bench_default.pt",
                   help="output torch file")
    p.add_argument("--bf16", action="store_true",
                   help="store the weights as bfloat16")
    args = p.parse_args(argv)
    return make(args.src, args.dst, args.bf16)


if __name__ == "__main__":
    main()
