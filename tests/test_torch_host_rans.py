"""The port's host rANS coder (``mlic_tpu_torch/entropy/rans``) and the
conditional Gaussian's host tables against the JAX package's.

Byte-identical streams to ``mlic_tpu.entropy.rans.coder`` on seeded symbols
with escapes, over the Gaussian tables and the factorized prior's; decode
round trips, one-shot and a phase at a time; the library against the plain
numpy coder; ``GaussianConditionalTables`` bit-equal to JAX's; the build
safe when two processes start it together into an empty directory, and a
failed build raising.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlic_tpu.entropy import models as jax_models
from mlic_tpu.entropy.rans import coder as jax_coder
from mlic_tpu_torch.entropy.models import (
    GaussianConditionalTables,
    entropy_bottleneck_tables,
)
from mlic_tpu_torch.entropy.rans import coder
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tables():
    gc = GaussianConditionalTables.create()
    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    eb = entropy_bottleneck_tables(model.entropy_bottleneck.numpy_params())
    return {"gauss": (gc.quantized_cdf, gc.cdf_length, gc.offset),
            "eb": eb[:3]}


def _symbols(tabs, n: int, seed: int, esc_share: float = 0.03):
    """Seeded (symbols, indexes): values inside each row's support, and
    ``esc_share`` of them outside it, some far (several bypass digits)."""
    _, lengths, offsets = tabs
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(lengths), n).astype(np.int32)
    span = lengths[idx] - 2
    sym = offsets[idx] + (rng.random(n) * span).astype(np.int32)
    esc = rng.random(n) < esc_share
    far = rng.integers(1, 1 << 20, n)
    below = rng.random(n) < 0.5
    sym = np.where(esc & below, offsets[idx] - far, sym)
    sym = np.where(esc & ~below, offsets[idx] + span + far - 1, sym)
    return sym.astype(np.int32), idx


@pytest.mark.parametrize("which", ["gauss", "eb"])
def test_streams_byte_identical_to_jax_coder(tables, which):
    tabs = tables[which]
    sym, idx = _symbols(tabs, 50_000, seed=1)
    stream = coder.encode_with_indexes(sym, idx, *tabs)
    assert stream == jax_coder.encode_with_indexes(sym, idx, *tabs)
    back = coder.decode_with_indexes(stream, idx, *tabs)
    np.testing.assert_array_equal(back, sym)


def test_streaming_decoder_equals_one_shot(tables):
    tabs = tables["gauss"]
    sym, idx = _symbols(tabs, 20_000, seed=2)
    enc = coder.BufferedRansEncoder()
    cuts = [0, 3000, 3001, 9000, 20_000]
    for a, b in zip(cuts, cuts[1:]):
        enc.encode_with_indexes(sym[a:b], idx[a:b])
    stream = enc.flush(*tabs)
    assert stream == coder.encode_with_indexes(sym, idx, *tabs)
    dec = coder.RansDecoder()
    dec.set_stream(stream)
    parts = [dec.decode_stream(idx[a:b], *tabs)
             for a, b in zip(cuts, cuts[1:])]
    dec.close()
    np.testing.assert_array_equal(np.concatenate(parts),
                                  coder.decode_with_indexes(stream, idx,
                                                            *tabs))
    np.testing.assert_array_equal(np.concatenate(parts), sym)


@pytest.mark.parametrize("which", ["gauss", "eb"])
def test_native_equals_plain_version(tables, which):
    tabs = tables[which]
    sym, idx = _symbols(tabs, 3000, seed=3, esc_share=0.05)
    stream = coder.encode_with_indexes(sym, idx, *tabs)
    assert stream == coder.numpy_encode(sym, idx, *tabs)
    plain = coder.NumpyDecoder(stream)
    np.testing.assert_array_equal(
        np.concatenate([plain.decode(idx[:1000], *tabs),
                        plain.decode(idx[1000:], *tabs)]), sym)


def test_garbage_and_bad_input(tables):
    """A corrupted stream decodes to garbage without faulting; indexes or
    tables that would read outside the rows raise before the C code."""
    tabs = tables["gauss"]
    sym, idx = _symbols(tabs, 2000, seed=4)
    stream = bytearray(coder.encode_with_indexes(sym, idx, *tabs))
    stream[8:40] = bytes(32)
    out = coder.decode_with_indexes(bytes(stream), idx, *tabs)
    assert out.shape == sym.shape
    assert coder.decode_with_indexes(b"", idx[:10], *tabs).shape == (10,)
    with pytest.raises(ValueError, match="indexes outside"):
        coder.encode_with_indexes(sym[:2], np.array([0, 64]), *tabs)
    with pytest.raises(ValueError, match="one index a symbol"):
        coder.encode_with_indexes(sym[:3], idx[:2], *tabs)
    with pytest.raises(RuntimeError, match="set_stream"):
        coder.RansDecoder().decode_stream(idx[:2], *tabs)


def test_gaussian_tables_equal_jax():
    ours = GaussianConditionalTables.create()
    theirs = jax_models.GaussianConditionalTables.create()
    for field in ("scale_table", "quantized_cdf", "cdf_length", "offset"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    table = np.exp(np.linspace(np.log(0.2), np.log(40.0), 17))
    np.testing.assert_array_equal(
        GaussianConditionalTables.create(table, 1e-6).quantized_cdf,
        jax_models.GaussianConditionalTables.create(table,
                                                    1e-6).quantized_cdf)


_BUILD = """
import sys
from pathlib import Path
from mlic_tpu_torch.entropy.rans import coder
coder.BUILD_DIR = Path(sys.argv[1])
assert coder.rans_backend() == "native"
print(coder.library_path())
"""


def test_two_processes_build_into_an_empty_directory(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    lib = paths.pop()
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [os.path.basename(lib), os.path.basename(lib)[:-3] + ".lock"])


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "rans.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(coder, "SOURCE", bad)
    monkeypatch.setattr(coder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        coder.build()
    assert not list((tmp_path / "build").glob("*.so"))
