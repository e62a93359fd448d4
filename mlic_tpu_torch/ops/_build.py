"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: a file builds in seconds).  Libraries go to ``build/kernels`` at
the repository root, named by a hash of their sources, and are built at
first use or all at once, in parallel, by ``build()``.  Nothing is built or
loaded when this module is imported.

Every kernel's C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``Kernel.launch`` raises if
that is not 0 and counts the launch.  Each kernel also counts its own
launches on the device (``csrc/launch_count.cuh``: thread 0 of block 0 adds
one), which ``device_launch_counts()`` reads: a launch that the host
issued and the device never ran shows as a difference between the two
counts, with no profiler involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from mlic_tpu_torch import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._device_count = None

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in [CSRC / self.source] + sorted(CSRC.glob("*.cuh")):
            h.update(f.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def function(self, symbol: str, argtypes: list, restype=_I):
        """A C function of this kernel's library, built at first use."""
        path = self.library_path()
        if not path.exists():
            build([self])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn

    def _function(self):
        if self._fn is None:
            self._fn = self.function(self.symbol, self.argtypes)
        return self._fn

    def launch(self, *args) -> None:
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch "
                               f"(cudaError {rc})")
        self.launches += 1

    def device_launches(self) -> int:
        """The launches of this kernel that ran on the device since its
        library was loaded: the library's count in device memory
        (``<name>_device_launches``), read with a blocking copy, so call it
        after a synchronize.  0 for a library this process never loaded."""
        if self._fn is None:
            return 0
        if self._device_count is None:
            self._device_count = self.function(
                f"{self.name}_device_launches", [_P])
        out = ctypes.c_ulonglong(0)
        rc = self._device_count(ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"reading {self.name}'s device launch count "
                               f"failed (cudaError {rc})")
        return out.value


KERNELS = {k.name: k for k in (
    # rows, table, out, n, n_rows, n_cols, stream
    Kernel("select_rows", "select_rows.cu", "select_rows_launch",
           [_P, _P, _P, _LL, _I, _I, _P]),
    # k, m, b, A, C, B, out, n_total, n_cols, stream
    Kernel("eval_cdf", "eval_cdf.cu", "eval_cdf_launch",
           [_P] * 7 + [_LL, _LL, _P]),
    # y_sym, y_idx, z_sym, row_params, n_rows, y_gather, cdf_rows, width,
    # n_cdf_rows, max_value, offsets, z_rows_base, n_z_rows, n_images, n_y,
    # n_z, z_start, z_freqm1, z_esc, y_start, y_freqm1, y_esc, stream
    Kernel("rans_encode_prep", "rans_encode_prep.cu",
           "rans_encode_prep_launch",
           [_P] * 4 + [_I, _I, _P, _I, _I, _P, _P] + [_I] * 5 + [_P] * 7),
    # z_start, z_freqm1, y_start, y_freqm1, x_out, words, masks, n_images,
    # n_lanes, n_z, n_per, n_phases, stream
    Kernel("rans_encode_scan", "rans_encode.cu", "rans_encode_launch",
           [_P] * 7 + [_I] * 5 + [_P]),
    # masks, words, x, z_esc, z_sym, y_esc, y_sym, control, status, buf,
    # img_n, ebuf, ecount, n_images, n_lanes, n_z, n_per, n_phases,
    # steps_per_item, items_per_image, stream
    Kernel("rans_encode_compact", "rans_compact.cu", "rans_compact_launch",
           [_P] * 13 + [_I] * 7 + [_P]),
    # words, n_words, x_in, ptr_in, x_out, ptr_out, sym, esc, S, n_images,
    # n_lanes, mode (0 parametric, 1 integer rows), layout (0 global, 1
    # lanes), rows, n_steps, row_params, n_param_rows, cdf_rows, width,
    # max_value, offsets, stream
    Kernel("rans_decode_phase", "rans_decode.cu", "rans_decode_launch",
           [_P, _LL] + [_P] * 6 + [_I] * 5 + [_P, _I, _P, _I, _P, _I, _P,
                                              _P, _P]),
    # mid, skip, out, dw, bdw, pw, bpw, gamma, beta, B, C, N, H, W, act,
    # is_bf16, stream
    Kernel("fused_block_tail", "fused_block_tail.cu",
           "fused_block_tail_launch", [_P] * 9 + [_I] * 7 + [_P]),
    # &Problem (pointers, strides, shapes; ops/invariant_matmul.Problem),
    # stream
    Kernel("invariant_matmul", "invariant_matmul.cu",
           "invariant_matmul_launch", [_P, _P]),
)}

# Second C entry points that no module of the package calls: K8's chain
# oracle (one thread an output, the plain fmaf loop over k = 0 .. K-1, the
# bias after; not counted on the device), which chip_smoke.py holds K8 to
# bit for bit.  {kernel: (symbol, argtypes)}, for ``Kernel.function``.
ORACLES = {"invariant_matmul": ("invariant_matmul_oracle_launch", [_P, _P])}


def build(kernels=None) -> dict:
    """Compile the kernels whose libraries are missing, one ``nvcc`` per
    source, all started together.  Returns {name: seconds} of this call's
    builds (0.0 for a library that was already there); the call's seconds
    are the set-up span ``setup.kernels``."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, secs = [], {}
    t0 = time.perf_counter()
    for k in kernels:
        path = k.library_path()
        secs[k.name] = 0.0
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / k.source)]
        procs.append((k, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for k, path, tmp, proc in procs:
        out, _ = proc.communicate()
        secs[k.name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{k.source}:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    spans.setup("setup.kernels", t0)
    return secs


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def device_launch_counts() -> dict:
    """{kernel: launches that ran on the device since its library was
    loaded}; call after a synchronize, and compare differences of two
    readings with the host's (``launch_counts`` may have been reset)."""
    return {name: k.device_launches() for name, k in KERNELS.items()}


def stream_handle(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes.
    ``torch.cuda.current_stream(dev).cuda_stream`` builds a Stream object
    and costs several microseconds a launch; the raw handle is what it
    holds."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
