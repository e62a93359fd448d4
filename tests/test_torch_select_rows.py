"""The port's row select (plain version of kernel K1) against the JAX
package's: the Pallas kernel in interpret mode, the XLA compare+select
chain, and ``table[row]`` -- all exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.entropy.device_rans import _select_rows_core
from mlic_tpu.entropy.parametric import gaussian_row_params
from mlic_tpu.entropy.cdf import get_scale_table
from mlic_tpu.ops.pallas_select import select_rows_pallas
from mlic_tpu_torch.ops.select_rows import select_rows, select_rows_plain


def _table_rows(shape, seed, n_rows=66, n_cols=6):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    row = rng.integers(0, n_rows, shape).astype(np.int32)
    return table, row


@pytest.mark.parametrize("shape", [(7, 333), (2, 64 * 64), (48, 64)])
def test_select_rows_matches_pallas_interpret(shape):
    from jax.experimental.pallas import tpu as pltpu

    table, row = _table_rows(shape, 0)
    with pltpu.force_tpu_interpret_mode():
        cols = jax.jit(lambda r: select_rows_pallas(r, jnp.asarray(table)))(
            jnp.asarray(row))
    got = select_rows(torch.from_numpy(row), torch.from_numpy(table))
    assert got.shape == (6,) + shape and got.dtype == torch.float32
    for j, c in enumerate(cols):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(c))
        np.testing.assert_array_equal(got[j].numpy(), table[row][..., j])


def test_select_rows_matches_xla_chain_out_of_range():
    """Rows outside [0, n_rows) select row 0, as the compare+select chain
    (and the TPU kernel built on it) does."""
    table, row = _table_rows((5, 40), 1, n_rows=9, n_cols=4)
    row[0, :10] = [-3, -1, 9, 10, 100, 0, 8, 4, -7, 12]
    ref = _select_rows_core(jnp.asarray(row), jnp.asarray(table))
    got = select_rows_plain(torch.from_numpy(row), torch.from_numpy(table))
    for j, c in enumerate(ref):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(c))


def test_select_rows_codec_table_exact():
    """The codec's own table (Gaussian row params + pad row) at a decode
    phase's [steps, B*n_lanes] shape."""
    params, _, _ = gaussian_row_params(get_scale_table())
    rng = np.random.default_rng(2)
    row = rng.integers(0, params.shape[0], (12, 64)).astype(np.int32)
    got = select_rows(torch.from_numpy(row), torch.from_numpy(params))
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), params[row])
