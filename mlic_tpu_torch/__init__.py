"""MLIC++ in PyTorch for one NVIDIA H100: serving, evaluation and training.

A port of ``mlic_tpu``'s codec -- its ``device`` backend (stream format v4:
analyze -> context encode pass -> interleaved rANS encode, and the matching
on-device decode; the two-deep serving pipeline and
``python -m mlic_tpu_torch.tools.serve``) and its ``steps`` and ``fused``
backends (the reference's streams, coded on the host by the port's rANS
coder, ``entropy/rans``) -- of its evaluation harness
(``eval.evaluate_codec``, ``python -m mlic_tpu_torch.tools.test``,
``tools.rd_vbr``) and of its training path to PyTorch, with hand-written CUDA
kernels for the row select, the analytic CDF evaluator, the two rANS scans
and the fused residual-block tail of g_a and g_s (``mlic_tpu_torch/csrc``;
the last is selected by ``MLIC_FUSED_BLOCKS=1``).  Every kernel has a plain
PyTorch twin in the same module; the twin runs for CPU tensors, the kernel
for CUDA tensors.

This package imports torch, numpy and scipy only -- never jax/flax or the
``mlic_tpu`` package.  Entry points default to ``device="cuda"`` and raise
when CUDA is missing; pass ``device="cpu"`` explicitly for the CPU path.

Layout: public model methods and the codec take and return NHWC arrays
(images ``[B,H,W,3]``; symbol/index arrays raveled in NHWC order, which is
the stream's position order).  The ``nn.Module``s inside are NCHW.
"""
