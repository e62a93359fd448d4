"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to CUDA and refuse to fall back to the CPU, and its
kernel wrappers run their plain versions only for CPU tensors."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "mlic_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import {name}")
        return None

sys.meta_path.insert(0, Block())
import mlic_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mlic_tpu_torch.__path__,
                                               "mlic_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print(" ".join(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 67                       # every module was imported
    for name in ("tools.decode", "tools.extract_decoder", "tools.serve",
                 "tools.rd_vbr", "tools.ab_stream_format", "entropy.rans",
                 "entropy.rans.coder", "data.autoaugment", "utils.misc",
                 "parallel", "parallel.mesh", "parallel.serving",
                 "perceptual", "tools.statistics", "perceptual_metrics",
                 "analysis", "analysis.freq", "analysis.cluster",
                 "analysis.compare", "analysis.cache", "tools.bdrate",
                 "tools.rd_curve", "tools.jpeg_anchor", "tools.profile_codec",
                 "tools.profile_modules", "tools.microbench", "tools.macs",
                 "ops.invariant_matmul", "tools.batch_contract"):
        assert f"mlic_tpu_torch.{name}" in names


def test_entry_points_default_to_cuda():
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.device import resolve_device
    from mlic_tpu_torch.models.registry import get_model

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Codec(get_model("MLICPP_TINY"))


def test_wrappers_take_plain_version_only_on_cpu():
    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.parametric import eval_cdf
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.ops.fused_block import fused_block_tail
    from mlic_tpu_torch.ops.invariant_matmul import conv2d, linear
    from mlic_tpu_torch.ops.select_rows import select_rows

    table = torch.randn(5, 6)
    row = torch.randint(0, 5, (4, 8), dtype=torch.int32)
    before = _build.launch_counts()
    cols = select_rows(row, table)
    eval_cdf(torch.zeros(3, 8, dtype=torch.int32), *cols[:5, 0])
    sec = torch.zeros(2, 12, dtype=torch.int32)
    dr.rans_encode_prep(sec, sec, sec[:, :0], {"row_params": table})
    x, words, masks = dr.rans_encode_scan(sec, sec + 100, sec, sec + 100, 4,
                                          3)
    dr.rans_encode_compact(x, words, masks, sec.bool(), sec, sec.bool(), sec,
                           4, 3)
    for dt in (torch.float32, torch.bfloat16):
        out = fused_block_tail(
            torch.randn(1, 4, 5, 7).to(dt), torch.randn(1, 6, 5, 7).to(dt),
            torch.randn(4, 1, 3, 3), torch.randn(4), torch.randn(6, 4, 1, 1),
            torch.randn(6), torch.rand(6, 6), 1 + torch.rand(6), act="igdn")
        assert out.shape == (1, 6, 5, 7) and out.dtype == dt
    with torch.no_grad():
        assert linear(torch.randn(2, 5, 8), torch.randn(3, 8)).shape == (
            2, 5, 3)
        assert conv2d(torch.randn(2, 4, 5, 7),
                      torch.randn(6, 4, 5, 5)).shape == (2, 6, 5, 7)
    assert _build.launch_counts() == before       # no kernel launched
    assert set(before) == {"select_rows", "eval_cdf", "rans_encode_prep",
                           "rans_encode_scan", "rans_encode_compact",
                           "rans_decode_phase", "fused_block_tail",
                           "invariant_matmul"}
    with pytest.raises(ValueError, match="CUDA device"):
        fused_block_tail(*(t.to("meta") for t in (
            torch.randn(1, 4, 5, 7), torch.randn(1, 6, 5, 7),
            torch.randn(4, 1, 3, 3), torch.randn(4), torch.randn(6, 4, 1, 1),
            torch.randn(6))), act="gelu")
    with pytest.raises(ValueError):
        select_rows(row.to("meta"), table.to("meta"))
    with pytest.raises(ValueError, match="n_lanes"):
        from mlic_tpu_torch.codec import Codec
        from mlic_tpu_torch.models.registry import get_model
        Codec(get_model("MLICPP_TINY"), n_lanes=2048, device="cpu")


def test_fused_kernel_source_is_its_own_cuda():
    """K5's source computes its products itself: no library product or
    convolution, no Triton, and a plain C entry point without PyTorch's
    headers."""
    from mlic_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_block_tail.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for banned in ("cublas", "cudnn", "cutlass", "torch", "triton", "atomic"):
        assert banned not in code.lower(), banned
    for needed in ("__global__", 'extern "C"', "tanhf", "rsqrtf", "fmaf",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "cudaGetLastError"):
        assert needed in code, needed


def test_port_sources_name_no_jax_import():
    """No module of the port, nor the smoke script, imports JAX, flax,
    optax, orbax, tensorstore or the JAX package, even inside a
    function."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|"
                     r"tensorstore|mlic_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mlic_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 55
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_kernel_sources_are_listed():
    from mlic_tpu_torch.ops import _build

    for k in _build.KERNELS.values():
        assert (_build.CSRC / k.source).is_file()
        assert k.library_path().parent == _build.BUILD_DIR
    k5 = _build.KERNELS["fused_block_tail"]
    assert k5.source == "fused_block_tail.cu"
    assert k5.symbol in (_build.CSRC / k5.source).read_text()
    assert (_build.CSRC / "cdf.cuh").is_file()
    # K2 and K4 evaluate the CDF through the one shared header
    for src in ("eval_cdf.cu", "rans_decode.cu"):
        assert '#include "cdf.cuh"' in (_build.CSRC / src).read_text()


def test_host_coder_source_is_the_ports_own():
    """The host rANS coder builds from the port's own ``rans.cpp``, which
    includes only the C++ standard library, into the build directory."""
    import re
    from pathlib import Path

    from mlic_tpu_torch.entropy.rans import coder

    assert coder.SOURCE.parent == Path(ROOT, "mlic_tpu_torch", "entropy",
                                       "rans")
    includes = re.findall(r"^\s*#\s*include\s*(\S+)",
                          coder.SOURCE.read_text(), re.M)
    assert includes and all(i in ("<cstdint>", "<cstring>", "<vector>")
                            for i in includes), includes
    assert coder.library_path().parent == coder.BUILD_DIR
    assert coder.BUILD_DIR.relative_to(ROOT).parts == ("build", "host")
