"""Stream format v2 (per-lane word blocks) in the port against the JAX
package, on the CPU.

The port's host coder (``entropy/rans/coder.encode_interleaved``, its own
``rans.cpp``) writes the JAX host coder's bytes for the same symbols,
indexes and tables, at several lane counts, with escapes, with fewer
symbols than lanes and with none; its decode gives the symbols back.  The
port's device encode (``device_rans.encode_interleaved_device`` and
``encode_positions_device``, fmt="lanes": K7 and K3, here their plain
versions, then the per-lane compaction) writes the same bytes per image,
over the Gaussian tables with the analytic prep and with gathers (and,
with fmt="global", the port's host ``encode_global``'s v3 bytes), and K4's
lane layout (``make_decoder(fmt="lanes")``, its plain version here)
decodes them exactly, parametric and by the integer rows.
"""

import numpy as np
import pytest
import torch

from mlic_tpu.entropy.cdf import build_cdf_tables
from mlic_tpu.entropy.rans import coder as jcoder
from mlic_tpu_torch.entropy import device_rans as dr
from mlic_tpu_torch.entropy import parametric
from mlic_tpu_torch.entropy.rans import coder
from mlic_tpu_torch.entropy.stream import (assemble_lane_streams,
                                           lane_decode_inputs, pack_streams,
                                           parse_interleaved)


@pytest.fixture(scope="module")
def small_tables():
    rng = np.random.default_rng(0)
    n_ctx, max_len = 8, 24
    lengths = rng.integers(2, max_len + 1, size=n_ctx)
    pmfs, tails = np.zeros((n_ctx, max_len)), np.zeros(n_ctx)
    for i, n in enumerate(lengths):
        p = rng.random(n) + 1e-4
        p /= p.sum() * 1.02
        pmfs[i, :n], tails[i] = p, 1 - p.sum()
    cdfs, cdf_lengths = build_cdf_tables(pmfs, lengths, tails, max_len)
    offsets = rng.integers(-10, 10, size=n_ctx).astype(np.int32)
    return cdfs, cdf_lengths, offsets


@pytest.mark.parametrize("n_lanes,n", [(4, 4096), (32, 1000), (256, 3),
                                       (8, 0), (1, 17)])
def test_host_bytes_equal_jax(small_tables, n_lanes, n):
    cdfs, lengths, offsets = small_tables
    rng = np.random.default_rng(n_lanes + n)
    idx = rng.integers(0, len(lengths), n).astype(np.int32)
    sym = rng.integers(-12, 12, n).astype(np.int32)
    if n > 100:
        sym[5], sym[77] = 100000, -100000       # escapes
    got = coder.encode_interleaved(sym, idx, n_lanes, cdfs, lengths, offsets)
    assert got == jcoder.encode_interleaved(sym, idx, n_lanes, cdfs,
                                            lengths, offsets)
    assert np.array_equal(coder.decode_interleaved(got, idx, cdfs, lengths,
                                                   offsets), sym)
    words, begin, esc = parse_interleaved(got)
    jw, jb, je = jcoder.parse_interleaved(got)
    assert np.array_equal(words, jw) and np.array_equal(begin, jb) \
        and np.array_equal(esc, je)


def test_host_decode_refuses_a_cut_stream(small_tables):
    cdfs, lengths, offsets = small_tables
    idx = np.zeros(64, np.int32)
    stream = coder.encode_interleaved(np.full(64, 100000, np.int32), idx, 4,
                                      cdfs, lengths, offsets)
    with pytest.raises(ValueError, match="truncated"):
        parse_interleaved(stream[:-8])


@pytest.fixture(scope="module")
def gaussian():
    scales = np.exp(np.linspace(np.log(0.11), np.log(64.0), 16))
    params, lengths, offsets = parametric.gaussian_row_params(scales)
    table = parametric.generate_tables(torch.as_tensor(params), lengths)
    tabs = dr.parametric_device_tables(params, lengths, offsets, table, "cpu")
    return params, lengths, offsets, np.asarray(table), tabs


def _payload(lengths, offsets, shape, seed, esc_rate=0.02):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(lengths) - 1, shape).astype(np.int32)
    sym = (offsets[idx] + rng.integers(0, lengths[idx] - 2)).astype(np.int32)
    esc = rng.random(shape) < esc_rate
    sym[esc] = rng.integers(-3000, 3000, int(esc.sum()))
    return sym, idx


def _host_streams(sym, idx, n_lanes, n_phases, pad_row, table, lengths,
                  offsets, encode=jcoder.encode_interleaved):
    """Each image's phases padded to a lane multiple with pad-row symbols,
    coded by ``encode`` (the JAX host coder's v2)."""
    b, total = sym.shape
    n_per = total // n_phases
    pad = -n_per % n_lanes
    s = np.pad(sym.reshape(b, n_phases, n_per), ((0, 0), (0, 0), (0, pad)))
    i = np.pad(idx.reshape(b, n_phases, n_per), ((0, 0), (0, 0), (0, pad)),
               constant_values=pad_row)
    return [encode(s[k].ravel(), i[k].ravel(), n_lanes, table, lengths,
                   offsets) for k in range(b)]


@pytest.mark.parametrize("n_lanes,n_per,phases,batch",
                         [(16, 16 * 9 + 5, 4, 3), (32, 7, 2, 2), (1, 5, 3, 2)])
def test_device_encode_and_lane_decode(gaussian, n_lanes, n_per, phases,
                                       batch):
    """Ragged phases, fewer symbols than lanes (7 of 32), one lane."""
    params, lengths, offsets, table, tabs = gaussian
    pad_row = len(lengths) - 1
    sym, idx = _payload(lengths, offsets, (batch, phases * n_per),
                        n_lanes + n_per)
    host = _host_streams(sym, idx, n_lanes, phases, pad_row, table, lengths,
                         offsets)
    t_sym, t_idx = torch.from_numpy(sym), torch.from_numpy(idx)
    for rows in (0, params.shape[0]):     # gathers, analytic prep
        out = dr.encode_interleaved_device(t_sym, t_idx, tabs, n_lanes,
                                           phases, "lanes", rows)
        assert assemble_lane_streams(out, n_lanes) == host
    # the same bytes from the pre-ordered positions
    parts = [dr.phase_order(t[:, k * n_per:(k + 1) * n_per], n_lanes, pv)
             for t, pv in ((t_sym, 0), (t_idx, pad_row))
             for k in range(phases)]
    positions = (torch.cat(parts[:phases]), torch.cat(parts[phases:]), tabs,
                 batch)
    out = dr.encode_positions_device(*positions, "lanes", params.shape[0])
    assert assemble_lane_streams(out, n_lanes) == host
    # fmt="global": format v3's streams, the port's host encode_global
    v3 = _host_streams(sym, idx, n_lanes, phases, pad_row, table, lengths,
                       offsets, coder.encode_global)
    for comp in (dr.encode_interleaved_device(t_sym, t_idx, tabs, n_lanes,
                                              phases, "global"),
                 dr.encode_positions_device(*positions, "global")):
        n_w, n_e = int(comp["img_n"].sum()), int(comp["ecount"].sum())
        assert pack_streams(comp["img_n"].numpy(), comp["ecount"].numpy(),
                            comp["buf"][:n_w].numpy().view(np.uint16),
                            comp["ebuf"][:n_e].numpy(), n_lanes,
                            v4=False) == v3

    args = lane_decode_inputs(host, "cpu")
    row_steps = int(np.ceil(np.log2(lengths.max())))
    steps = parametric.bisect_steps(lengths)
    for n_steps_row in (None, row_steps):
        init, decode = dr.make_decoder(args["words"], steps, args["esc"],
                                       args["esc_begin"], n_lanes,
                                       fmt="lanes")
        carry, got = init(args["lane_begin"]), []
        for k in range(phases):
            rws = dr.phase_order(t_idx[:, k * n_per:(k + 1) * n_per],
                                 n_lanes, pad_row).contiguous()
            carry, o = decode(carry, rws, tabs, n_steps_row)
            got.append(o.reshape(-1, batch, n_lanes).permute(1, 0, 2)
                       .reshape(batch, -1)[:, :n_per])
        assert torch.equal(torch.cat(got, 1), t_sym)


def test_lane_layout_reads_each_lanes_block():
    """The plain K4 lane layout's renormalization reads each lane's next
    word and advances only the lanes that read; the wrapper refuses an
    unknown layout."""
    words = torch.arange(100, 120, dtype=torch.int16)
    x, ptr = dr.rans_init(words, torch.tensor([0, 10], dtype=torch.int32))
    assert x.tolist() == [100 << 16 | 101, 110 << 16 | 111]
    assert ptr.tolist() == [2, 12]
    x2, p2 = dr._renorm_lanes_plain(torch.tensor([5, 1 << 20]), ptr, words)
    assert x2.tolist() == [5 << 16 | 102, 1 << 20] and p2.tolist() == [3, 12]
    with pytest.raises(ValueError, match="layout"):
        dr.rans_decode_phase(words, x, ptr, 2, 4,
                             torch.zeros(1, 2, dtype=torch.int32), {}, True,
                             "rows")
