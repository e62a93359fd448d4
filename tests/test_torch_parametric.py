"""The port's table construction against the JAX package's.

Exact where the JAX package is exact by construction: the scipy row
parameters, the numpy CDF quantizer and the factorized-prior tables.  The
parametric integer table is the port's own (torch.erfc and XLA's erfc
differ in the last ulp on some inputs); it must pass the rANS validity
check and both self-checks, and differ from JAX's in few entries, each by
+-1.
"""

import hashlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.entropy import cdf as jcdf
from mlic_tpu.entropy import models as jmodels
from mlic_tpu.entropy import parametric as jp
from mlic_tpu.entropy.models import EntropyBottleneck as FlaxEB
from mlic_tpu_torch.entropy import cdf as tcdf
from mlic_tpu_torch.entropy import models as tmodels
from mlic_tpu_torch.entropy import parametric as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A fresh process on four threads: a payload-sized evaluation as its first
# erfc, then the table; the digests of both, what both self-checks count,
# and the thread count afterwards.
_FRESH_TABLE = """
import hashlib, torch
torch.set_num_threads(4)
from mlic_tpu_torch.entropy import cdf, parametric as tp
params, lengths, _ = tp.gaussian_row_params(cdf.get_scale_table())
p = torch.from_numpy(params)
k = torch.arange(8192, dtype=torch.int32)[:, None].expand(8192, len(params))
big = tp.eval_cdf(k.contiguous(), *p.t()[:5]).numpy()
table = tp.generate_tables(p, lengths)
print(hashlib.sha256(big.tobytes()).hexdigest(),
      hashlib.sha256(table.tobytes()).hexdigest(),
      tp.self_check(p, table, lengths), tp.self_check_encode(p, table, lengths),
      torch.get_num_threads())
"""


@pytest.fixture(scope="module")
def row_params():
    return tp.gaussian_row_params(tcdf.get_scale_table())


@pytest.fixture(scope="module")
def port_table(row_params):
    params, lengths, _ = row_params
    return tp.generate_tables(torch.from_numpy(params), lengths)


def test_gaussian_row_params_exact(row_params):
    ref = jp.gaussian_row_params(jcdf.get_scale_table())
    for got, want in zip(row_params, ref):
        np.testing.assert_array_equal(got, want)
    assert tp.bisect_steps(row_params[1]) == jp.bisect_steps(ref[1])


def test_cdf_quantizer_exact():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tcdf.get_scale_table(),
                                  jcdf.get_scale_table())
    pmfs = rng.random((6, 40)) ** 3
    lengths = rng.integers(3, 41, 6)
    tails = rng.random(6) * 1e-3
    for got, want in zip(tcdf.build_cdf_tables(pmfs, lengths, tails, 40),
                         jcdf.build_cdf_tables(pmfs, lengths, tails, 40)):
        np.testing.assert_array_equal(got, want)


def test_entropy_bottleneck_tables_exact():
    """Same factorized-prior parameters -> identical integer tables."""
    eb = FlaxEB(channels=8)
    z = jnp.zeros((1, 2, 2, 8))
    variables = eb.init({"params": jax.random.key(0),
                         "noise": jax.random.key(1)}, z, False)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), variables["params"])
    params["quantiles"][:, 0, 0] -= 3.0      # a wider support on some rows
    ref = jmodels.entropy_bottleneck_tables(params, 8)
    got = tmodels.entropy_bottleneck_tables(params)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)


def test_build_indexes_exact():
    st = tcdf.get_scale_table().astype(np.float32)
    scales = np.exp(np.random.default_rng(2).uniform(-4, 7, (3, 50))
                    ).astype(np.float32)
    scales[0, :5] = [0.0, 0.11, st[10], st[63], 1e4]
    ref = jmodels.build_indexes(jnp.asarray(scales), jnp.asarray(st))
    got = tmodels.build_indexes(torch.from_numpy(scales), torch.from_numpy(st))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_port_table_valid_and_self_checked(row_params, port_table):
    params, lengths, _ = row_params
    p = torch.from_numpy(params)
    assert tp.validate_tables(port_table, lengths) == 0
    assert tp.self_check(p, port_table, lengths, n_lanes=512) == 0
    assert tp.self_check(p, port_table, lengths, n_lanes=32) == 0
    assert tp.self_check_encode(p, port_table, lengths) == 0


def test_self_checks_count_a_corrupted_entry(row_params, port_table):
    params, lengths, _ = row_params
    bad = port_table.copy()
    bad[10, 5] += 1
    p = torch.from_numpy(params)
    assert tp.self_check(p, bad, lengths) == 1
    assert tp.self_check_encode(p, bad, lengths) == 2   # start of 5, freq of 4
    bad[20, 3] = bad[20, 2]
    assert tp.validate_tables(bad, lengths) == 1


def test_port_table_vs_jax_table(row_params, port_table):
    """Few entries differ from XLA's table, each by exactly one: 27 of
    27,259 with the CPU builds of torch and XLA, so a change in either
    evaluator's op sequence shows as more."""
    params, lengths, _ = row_params
    ref = jp.generate_tables(params, lengths)
    diff = port_table.astype(np.int64) - ref
    n_valid = int(np.sum(lengths))
    n_diff = int(np.count_nonzero(diff))
    print(f"port vs JAX parametric table: {n_diff} of {n_valid} valid "
          "entries differ")
    assert np.all(np.abs(diff) <= 1)
    assert n_diff <= 40


def test_why_the_tables_differ(row_params, port_table):
    """The two causes, counted over the valid (row, k) entries: erfc
    results that differ between torch and XLA on the same f32 argument,
    and arguments k*m + b that an FMA rounds differently from a separate
    multiply and add (XLA contracts them; the port never does)."""
    params, lengths, _ = row_params
    rows = np.repeat(np.arange(len(params)), lengths)
    ks = np.concatenate([np.arange(n) for n in lengths]).astype(np.float32)
    m, b = params[rows, 0], params[rows, 1]
    separate = (ks * m).astype(np.float32) + b
    fused = (ks.astype(np.float64) * m + b).astype(np.float32)
    arg = -separate
    erfc_t = torch.erfc(torch.from_numpy(arg)).numpy()
    erfc_j = np.asarray(jax.lax.erfc(jnp.asarray(arg)))
    n_erfc = int(np.count_nonzero(erfc_t != erfc_j))
    n_fma = int(np.count_nonzero(separate != fused))
    print(f"of {len(rows)} valid entries: erfc differs on {n_erfc}, "
          f"an FMA changes k*m+b on {n_fma}")
    assert len(rows) == int(np.sum(lengths))
    assert 0 < n_erfc < len(rows) and n_fma < len(rows)


def test_eval_cdf_plain_matches_formula(row_params):
    """eval_cdf on a stacked k broadcasts its columns by position (the
    encoder evaluates slot and slot+1 in one call)."""
    params, _, _ = row_params
    p = torch.from_numpy(params)
    k = torch.arange(6, dtype=torch.int32)[:, None].expand(6, len(params))
    both = tp.eval_cdf(torch.stack([k, k + 1]).contiguous(), *p.t()[:5])
    one = tp.eval_cdf(k.contiguous(), *p.t()[:5])
    assert torch.equal(both[0], one)
    assert torch.equal(both[1][:-1], one[1:])
    assert torch.equal(one[0], torch.zeros(len(params), dtype=torch.int32))


def test_cpu_erfc_runs_on_one_thread(row_params, monkeypatch):
    """On the CPU eval_cdf_plain computes erfc on the calling thread and
    gives torch's thread count back: a multi-threaded erfc once returned
    one thread's share several ulp off, and a table then failed its own
    self-checks."""
    params, _, _ = row_params
    p = torch.from_numpy(params)
    seen, erfc = [], torch.erfc

    def recording(x):
        seen.append(torch.get_num_threads())
        return erfc(x)

    monkeypatch.setattr(torch, "erfc", recording)
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        k = torch.arange(40, dtype=torch.int32)[:, None].expand(40, len(params))
        tp.eval_cdf(k.contiguous(), *p.t()[:5])
        assert seen == [1] and torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(threads)


def test_cpu_table_is_the_same_in_fresh_processes(row_params, port_table):
    """Two fresh processes on four threads, whose first erfc is a
    payload-sized evaluation, build the table of this process, bit for bit,
    pass both self-checks, and evaluate the payload as this process does."""
    params, _, _ = row_params
    p = torch.from_numpy(params)
    k = torch.arange(8192, dtype=torch.int32)[:, None].expand(8192, len(params))
    big = tp.eval_cdf(k.contiguous(), *p.t()[:5]).numpy()
    want = [hashlib.sha256(big.tobytes()).hexdigest(),
            hashlib.sha256(port_table.tobytes()).hexdigest(), "0", "0", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _FRESH_TABLE], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.split() == want
