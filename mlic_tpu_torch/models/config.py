"""Model configurations: a copy of ``mlic_tpu/models/config.py`` (reference
``MLIC++/config/config.py:19-62``).  The port keeps its own copy so it never
imports the JAX package."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    N: int
    M: int
    slice_num: int
    context_window: int = 5
    depthwise: bool = True          # depthwise-separable convs (fork default)
    small_decoder: bool = False     # MLICPP_*_SMALL_DEC: dense encoder, N//4 decoder
    old_synthesis: bool = False     # SynthesisTransformOld head (pre-fix weights)
    vbr: bool = False
    # VBR machinery (reference mlicpp_vbr.py:83-100 / mlicpp_sd_vbr.py:92-100)
    lmbda: tuple = ()
    gain_init: tuple = ()
    # QuantABCD dead-zone reconstruction in forward AND the real coding path
    # (reference ``no_quantoffset`` attribute, default True = off,
    # mlicpp_vbr.py:102; coding glue utils/ckbd.py:76-121,146-193).
    quant_offset: bool = False
    # Variable-rate hyper-latent: EntropyBottleneckVbr + gayn2zqstep MLP
    # (reference ``vr_entbttlnck`` ctor arg, mlicpp_vbr.py:104-117).
    vr_entbttlnck: bool = False
    # Let gradients flow into the Gain vector during stage-2 training.
    # OFF by default for parity: the reference detaches Gain in its forward
    # (``mlicpp_vbr.py:126-132``), training it only through the commented-out
    # variant — with False, the MGDA trainer's per-level gain-grad sum is
    # exactly zero, mirroring that frozen behavior.
    train_gain: bool = False
    # Compute dtype for the transforms OUTSIDE the entropy loop (g_a, h_a,
    # g_s): "bfloat16" halves MXU time without touching bitstream
    # determinism (entropy-parameter path stays float32).  Param dtype is
    # always float32, so checkpoints are interchangeable.
    transform_dtype: str = "float32"

    @property
    def slice_ch(self) -> int:
        assert self.M % self.slice_num == 0
        return self.M // self.slice_num


_VBR_LMBDA = (0.0005, 0.0035, 0.0067, 0.025, 0.0483, 0.18)
_VBR_GAIN = (0.06556, 0.13944, 0.19293, 0.37268, 0.51801, 1.0)
_SD_VBR_LMBDA = (0.0002, 0.0005, 0.0035, 0.0483, 0.18)
_SD_VBR_GAIN = (0.002424, 0.06556, 0.13944, 0.51801, 1.0)

CONFIGS: dict[str, ModelConfig] = {
    "MLICPP_L": ModelConfig("MLICPP_L", N=192, M=320, slice_num=10),
    "MLICPP_M": ModelConfig("MLICPP_M", N=160, M=256, slice_num=8),
    "MLICPP_S": ModelConfig("MLICPP_S", N=96, M=160, slice_num=5),
    "MLICPP_S2": ModelConfig("MLICPP_S2", N=128, M=128, slice_num=2),
    "MLICPP_M_SMALL_DEC": ModelConfig(
        "MLICPP_M_SMALL_DEC", N=192, M=320, slice_num=10, small_decoder=True),
    "MLICPP_S_VBR": ModelConfig(
        "MLICPP_S_VBR", N=96, M=160, slice_num=5, vbr=True,
        lmbda=_VBR_LMBDA, gain_init=_VBR_GAIN),
    "MLICPP_M_SMALL_DEC_VBR": ModelConfig(
        "MLICPP_M_SMALL_DEC_VBR", N=192, M=320, slice_num=10, small_decoder=True,
        vbr=True, lmbda=_SD_VBR_LMBDA, gain_init=_SD_VBR_GAIN),
    # Tiny configs for tests / CI (not in the reference zoo).
    "MLICPP_TINY": ModelConfig("MLICPP_TINY", N=32, M=64, slice_num=2),
    "MLICPP_TINY_VBR": ModelConfig(
        "MLICPP_TINY_VBR", N=32, M=64, slice_num=2, vbr=True,
        lmbda=(0.0018, 0.013, 0.0483), gain_init=(0.15, 0.4, 1.0)),
}


def model_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(CONFIGS)}") from None
