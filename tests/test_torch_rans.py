"""The port's format-v4 rANS (plain versions of kernels K1-K4) against the
JAX package's host coder (``mlic_tpu/entropy/rans/coder.py``).

Payloads mix a z section (factorized-prior rows, decoded by integer-row
bisection) with Gaussian y phases (analytic CDF), each padded to a lane
multiple, with 0% and 3% escapes.  The port's table is its own (see
test_torch_parametric.py), so the oracle is given the port's table.
"""

import numpy as np
import pytest
import torch

from mlic_tpu.entropy.rans import coder
from mlic_tpu_torch.codec import encode_rans_v4
from mlic_tpu_torch.entropy import device_rans as dr
from mlic_tpu_torch.entropy import parametric as tp
from mlic_tpu_torch.entropy.cdf import get_scale_table
from mlic_tpu_torch.entropy.stream import (
    _V4_FLAG,
    assemble_streams,
    parse_global,
    stream_is_unified,
    stream_lanes,
)

B, N_LANES, N_PHASES, N_PER, N_CH, Z_HW = 2, 16, 4, 100, 8, 6


def _random_cdf_rows(rng, n_rows, max_len):
    lengths = rng.integers(4, max_len + 1, n_rows).astype(np.int32)
    rows = np.zeros((n_rows, max_len), np.int32)
    offsets = rng.integers(-12, 1, n_rows).astype(np.int32)
    for i in range(n_rows):
        li = int(lengths[i])
        cuts = np.sort(rng.choice(np.arange(1, 1 << 16), li - 2,
                                  replace=False))
        rows[i, :li] = np.concatenate([[0], cuts, [1 << 16]])
    return rows, lengths, offsets


@pytest.fixture(scope="module")
def tables():
    params, g_len, g_off = tp.gaussian_row_params(get_scale_table())
    table = tp.generate_tables(torch.from_numpy(params), g_len)
    eb_rows, eb_len, eb_off = _random_cdf_rows(np.random.default_rng(5),
                                               N_CH, 40)
    n_g = table.shape[0]
    width = -(-max(table.shape[1], eb_rows.shape[1]) // 64) * 64
    rows = np.zeros((n_g + N_CH, width), np.int32)
    rows[:n_g, :table.shape[1]] = table
    rows[n_g:, :eb_rows.shape[1]] = eb_rows
    lengths = np.concatenate([g_len, eb_len]).astype(np.int32)
    offsets = np.concatenate([g_off, eb_off]).astype(np.int32)
    dev = dr.parametric_device_tables(params, lengths, offsets, rows, "cpu")
    return {"dev": dev, "rows": rows, "lengths": lengths, "offsets": offsets,
            "n_g": n_g, "n_steps": tp.bisect_steps(g_len),
            "z_steps": int(np.ceil(np.log2(width)))}


def _payload(t, esc_rate, seed):
    rng = np.random.default_rng(seed)
    lengths, offsets = t["lengths"], t["offsets"]
    idx = rng.integers(0, 64, (B, N_PHASES * N_PER)).astype(np.int32)
    span = lengths[idx] - 2
    sym = offsets[idx] + np.minimum(
        np.abs(np.rint(rng.standard_normal(idx.shape)
                       * get_scale_table()[idx])).astype(np.int64)
        + span // 2, span - 1)
    z_rows = t["n_g"] + np.arange(Z_HW * N_CH) % N_CH
    z = offsets[z_rows] + rng.integers(0, lengths[z_rows] - 2, (B, len(z_rows)))
    if esc_rate:
        for a, hi in ((sym, 3000), (z, 300)):
            m = rng.random(a.shape) < esc_rate
            a[m] = rng.integers(-hi, hi, int(m.sum()))
    return sym.astype(np.int32), idx, z.astype(np.int32)


def _oracle_inputs(t, sym, idx, z, b):
    """Image b's symbols and rows in position order, phases padded with
    pad-row symbols (the layout encode_global codes)."""
    pad_row = t["n_g"] - 1
    parts = [(z[b], t["n_g"] + np.arange(z.shape[1]) % N_CH)] + [
        (sym[b, k * N_PER:(k + 1) * N_PER], idx[b, k * N_PER:(k + 1) * N_PER])
        for k in range(N_PHASES)]
    syms, rows = [], []
    for s, r in parts:
        pad = (-len(s)) % N_LANES
        syms.append(np.concatenate([s, np.zeros(pad, np.int32)]))
        rows.append(np.concatenate([r, np.full(pad, pad_row)]))
    return np.concatenate(syms).astype(np.int32), \
        np.concatenate(rows).astype(np.int32)


@pytest.fixture(scope="module", params=[0.0, 0.03], ids=["esc0", "esc3"])
def coded(request, tables):
    sym, idx, z = _payload(tables, request.param, 7)
    comp = encode_rans_v4(torch.from_numpy(sym), torch.from_numpy(idx),
                          torch.from_numpy(z), tables["dev"], N_LANES,
                          N_PHASES, tables["n_g"])
    streams = assemble_streams(comp, N_LANES)
    return sym, idx, z, streams, request.param


def test_body_byte_identical_to_encode_global(tables, coded):
    sym, idx, z, streams, esc_rate = coded
    n_esc = 0
    for b, s in enumerate(streams):
        o_sym, o_row = _oracle_inputs(tables, sym, idx, z, b)
        ref = coder.encode_global(o_sym, o_row, N_LANES, tables["rows"],
                                  tables["lengths"], tables["offsets"])
        assert s[4:] == ref[4:]
        head, ref_head = (np.frombuffer(x[:4], np.uint32)[0] for x in (s, ref))
        assert head == ref_head | _V4_FLAG
        n_esc += int(np.frombuffer(s[8:12], np.uint32)[0])
    assert (n_esc > 0) == (esc_rate > 0)


def test_host_coder_reads_port_streams(tables, coded):
    sym, idx, z, streams, _ = coded
    for b, s in enumerate(streams):
        assert coder.stream_is_unified(s) and stream_is_unified(s)
        assert coder.stream_lanes(s) == stream_lanes(s) == N_LANES
        lanes, words, esc = coder.parse_global(s)
        p_lanes, p_words, p_esc = parse_global(s)
        assert lanes == p_lanes == N_LANES
        np.testing.assert_array_equal(words, p_words)
        np.testing.assert_array_equal(esc, p_esc)
        o_sym, o_row = _oracle_inputs(tables, sym, idx, z, b)
        got = coder.decode_global(s, o_row, tables["rows"], tables["lengths"],
                                  tables["offsets"])
        np.testing.assert_array_equal(got, o_sym)


def test_plain_decoder_recovers_symbols(tables, coded):
    """The decode path the model runs: rans_init_global, the z section by
    row bisection, then each y phase parametrically from select_rows
    pre-columns, escapes patched from the side channel."""
    from mlic_tpu_torch.ops.select_rows import select_rows

    sym, idx, z, streams, _ = coded
    parsed = [parse_global(s) for s in streams]
    words = torch.from_numpy(np.concatenate([p[1] for p in parsed])
                             .view(np.int16))
    cum = np.cumsum([0] + [len(p[1]) for p in parsed[:-1]])
    ecum = np.cumsum([0] + [len(p[2]) for p in parsed[:-1]])
    esc_vals = torch.from_numpy(np.concatenate([p[2] for p in parsed]))
    dev = tables["dev"]
    init, decode = dr.make_decoder(
        words, tables["n_steps"], esc_vals,
        torch.tensor(ecum, dtype=torch.int32), N_LANES)
    carry = init(torch.tensor(cum, dtype=torch.int32))
    z_rows = torch.from_numpy(
        (tables["n_g"] + np.arange(z.shape[1]) % N_CH).astype(np.int32))
    ordered = dr.phase_order(z_rows[None].expand(B, -1), N_LANES,
                             tables["n_g"] - 1).contiguous()
    carry, got = decode(carry, ordered, dev, n_steps_row=tables["z_steps"])
    out = [got]
    for k in range(N_PHASES):
        rows = dr.phase_order(torch.from_numpy(
            idx[:, k * N_PER:(k + 1) * N_PER]), N_LANES,
            tables["n_g"] - 1).contiguous()
        carry, got = decode(carry, rows, dev,
                            pre_cols=select_rows(rows, dev["row_params"]))
        out.append(got)
    want = torch.cat([dr.phase_order(torch.from_numpy(z), N_LANES, 0)] + [
        dr.phase_order(torch.from_numpy(sym[:, k * N_PER:(k + 1) * N_PER]),
                       N_LANES, 0) for k in range(N_PHASES)]).reshape(-1)
    assert torch.equal(torch.cat(out), want)
    # every word and escape consumed: the pointers end at each block's end
    ends = torch.tensor(cum + [len(p[1]) for p in parsed], dtype=torch.int32)
    assert torch.equal(carry[1], ends)
    assert torch.equal(carry[2], torch.tensor([len(p[2]) for p in parsed],
                                              dtype=torch.int32))


@pytest.mark.parametrize("n_lanes", [0, 33, 48, 1056])
def test_decode_phase_rejects_partial_warp_lane_counts(n_lanes):
    """The decode kernel's warp ballot names all 32 lanes from 32 lanes up,
    so the wrapper refuses counts the kernel cannot run, on any device."""
    words = torch.zeros(4 * max(n_lanes, 1), dtype=torch.int16)
    x = torch.full((max(n_lanes, 1),), 1 << 16, dtype=torch.int64)
    ptr = torch.zeros(1, dtype=torch.int32)
    cols = torch.zeros((6, 1, max(n_lanes, 1)), dtype=torch.float32)
    with pytest.raises(ValueError, match="n_lanes"):
        dr.rans_decode_phase(words, x, ptr, n_lanes, 1, cols=cols)


def test_encode_scan_matches_host_loop():
    """The plain encode scan against a per-lane Python reference of the
    rans16 step (emit iff x >= freq << 16)."""
    rng = np.random.default_rng(9)
    S, L = 40, 8
    freq = rng.integers(1, 1 << 12, (S, L))
    start = rng.integers(0, (1 << 16) - freq)
    x, words, emits = dr.rans_encode_scan(
        dr.u16_bits(torch.from_numpy(start)),
        dr.u16_bits(torch.from_numpy(freq - 1)))
    for lane in range(L):
        xl = 1 << 16
        for s in range(S - 1, -1, -1):
            f = int(freq[s, lane])
            e = xl >= (f << 16)
            assert bool(emits[s, lane]) == e
            assert int(words[s, lane]) & 0xFFFF == xl & 0xFFFF
            if e:
                xl >>= 16
            xl = ((xl // f) << 16) + xl % f + int(start[s, lane])
        assert int(x[lane]) == xl
