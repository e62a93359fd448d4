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


# --------------------------------------------------------------------------
# K4's T-way search (kary_search_plain) against the bisection
# --------------------------------------------------------------------------
_MASK16_T = (1 << 16) - 1


def _bisect_slots(cf, n_steps, **tabs):
    """(sym, start, freq, esc) of one step of ``rans_decode_phase_plain``
    per cf: one lane per image, so each lane's word pointer says whether it
    renormalized; two states with the same cf (x >> 16 = 1 and 2) give
    freq + cf - start and 2 freq + cf - start."""
    n = cf.shape[0]
    outs = []
    for hi16 in (1, 2):
        x = (torch.full((n,), hi16, dtype=torch.int64) << 16) | cf.long()
        sym, esc, xo, ptr = dr.rans_decode_phase_plain(
            torch.zeros(4, dtype=torch.int16), x,
            torch.zeros(n, dtype=torch.int32), 1, n_steps, **tabs)
        outs.append((sym[0], esc[0], torch.where(ptr > 0, xo >> 16, xo)))
    freq = outs[1][2] - outs[0][2]
    return outs[0][0], cf.long() + freq - outs[0][2], freq, outs[0][1]


def _assert_same_slots(got, want):
    for name, g, w in zip(("sym", "start", "freq", "esc"), got, want):
        assert torch.equal(g.long(), w.long()), name




@pytest.mark.parametrize("group", [2, 4, 8])
def test_kary_search_matches_bisection_parametric(tables, group):
    """Parametric mode: random rows and states, plus cf at every slot
    boundary of a few rows (the escape cf = 2^16 - 1 included)."""
    rp = tables["dev"]["row_params"]
    lengths = tables["lengths"]
    rng = np.random.default_rng(20 + group)
    idx = [rng.integers(0, tables["n_g"], 3000)]
    cf = [rng.integers(0, 1 << 16, 3000)]
    for r in (0, 1, 31, tables["n_g"] - 2):       # narrow to wide rows
        slots = torch.arange(1, int(lengths[r]) - 2, dtype=torch.int32)
        m, b, A, C, B, _ = rp[r]
        v = tp.eval_cdf_plain(slots, m, b, A, C, B).numpy()
        bnd = np.clip(np.unique(np.concatenate([v, v - 1, [0, _MASK16_T]])),
                      0, _MASK16_T)
        idx.append(np.full(len(bnd), r))
        cf.append(bnd)
    idx = torch.from_numpy(np.concatenate(idx))
    cf = torch.from_numpy(np.concatenate(cf).astype(np.int32))
    cols = rp[idx].t().contiguous()
    got = dr.decode_slot_plain(cf, group, tables["n_steps"], cols_s=cols)
    want = _bisect_slots(cf, tables["n_steps"], cols=cols[:, None, :])
    _assert_same_slots(got, want)
    assert bool(got[3].any()) and bool((cf == 0).any())


@pytest.mark.parametrize("group", [2, 4, 8])
def test_kary_search_matches_bisection_rows(tables, group):
    """Row-table mode (the z section): every slot boundary of the
    factorized-prior rows and of a few Gaussian rows, cf = 0 and 2^16 - 1,
    and random states."""
    dev = tables["dev"]
    rows_t, lengths = tables["rows"], tables["lengths"]
    rng = np.random.default_rng(30 + group)
    rows = [rng.integers(0, len(lengths), 2000)]
    cf = [rng.integers(0, 1 << 16, 2000)]
    for r in list(range(tables["n_g"], len(lengths))) + [0, 40]:
        v = rows_t[r, :int(lengths[r])].astype(np.int64)
        bnd = np.clip(np.unique(np.concatenate([v, v - 1, [0, _MASK16_T]])),
                      0, _MASK16_T)
        rows.append(np.full(len(bnd), r))
        cf.append(bnd)
    rows = torch.from_numpy(np.concatenate(rows).astype(np.int32))
    cf = torch.from_numpy(np.concatenate(cf).astype(np.int32))
    tabs = dict(cdf_rows=dev["cdf_rows"], max_value=dev["max_value"],
                offsets=dev["offsets"])
    got = dr.decode_slot_plain(cf, group, tables["z_steps"], row=rows, **tabs)
    want = _bisect_slots(cf, tables["z_steps"], rows=rows[None], **tabs)
    _assert_same_slots(got, want)
    assert bool(got[3].any())


def test_kary_search_on_tiny_codec_payload(monkeypatch):
    """The TINY codec's own streams: every phase that ``decompress``
    decodes is decoded again step by step with the T-way search for T in
    {2, 4, 8}; symbols, escape flags and the carry equal the bisection's."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.weights import init_params

    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    codec = Codec(model, n_lanes=16, device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3),
                                          dtype=np.uint8)
    enc = codec.compress(x)
    bisect = dr.rans_decode_phase
    phases = []

    def both(words, x, img_ptr, n_lanes, n_steps, cols=None, rows=None,
             cdf_rows=None, max_value=None, offsets=None):
        ref = bisect(words, x, img_ptr, n_lanes, n_steps, cols, rows,
                     cdf_rows, max_value, offsets)
        S = cols.shape[1] if cols is not None else rows.shape[0]
        for group in (2, 4, 8):
            xs, ptr = x, img_ptr
            for s in range(S):
                cf = (xs & 0xFFFF).to(torch.int32)
                sym, start, freq, esc = dr.decode_slot_plain(
                    cf, group, n_steps,
                    cols_s=None if cols is None else cols[:, s],
                    row=None if rows is None else rows[s],
                    cdf_rows=cdf_rows, max_value=max_value, offsets=offsets)
                assert torch.equal(sym, ref[0][s]) and torch.equal(esc, ref[1][s])
                xs = (freq.long() * (xs >> 16) + cf - start) & 0xFFFFFFFF
                xs, ptr = dr._renorm_global_plain(xs, ptr, words)
            assert torch.equal(xs, ref[2]) and torch.equal(ptr, ref[3])
        phases.append("cols" if cols is not None else "rows")
        return ref

    monkeypatch.setattr(dr, "rans_decode_phase", both)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert phases[0] == "rows" and phases.count("cols") == len(phases) - 1 > 0


@pytest.mark.parametrize("lanes", [list(range(1, 32)),
                                   [32, 64, 96, 128, 160, 192],
                                   [256, 320, 512, 768, 992, 1024]],
                         ids=["below_32", "32_to_192", "256_to_1024"])
def test_decode_cluster_sizing(lanes):
    """K4's blocks per image: one block below 32 lanes, at most the
    portable cluster of 8 blocks up to 1024 lanes, each block's lanes a
    whole share of the image's and at most 512 threads; 8 threads a lane
    up to 512 lanes, 4 above; partial warps from 32 lanes up refused."""
    for n in lanes:
        blocks = dr.decode_blocks_per_image(n)
        group = dr.decode_group(n)
        assert group == (8 if n <= 512 else 4)
        assert 1 <= blocks <= 8 and n % blocks == 0
        assert n // blocks * group <= 512 or n < 32
        if n < 32:
            assert blocks == 1
        elif blocks > 1:       # the fewest blocks that hold the lanes
            assert n // (blocks // 2) * group > 512
    # the codec's widths: 16 lanes in one block, 256 in 4, 512 and 1024 in 8
    assert [dr.decode_blocks_per_image(n) for n in (16, 256, 512, 1024)] == [
        1, 4, 8, 8]
    for n in (0, 33, 48, 1056):
        with pytest.raises(ValueError, match="n_lanes"):
            dr.decode_blocks_per_image(n)
