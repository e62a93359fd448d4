"""The port's format-v4 rANS (plain versions of kernels K3, K4, K6 and K7)
against the JAX package's host coder (``mlic_tpu/entropy/rans/coder.py``).

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
    row bisection, then each y phase parametrically from its rows of the
    Gaussian row-parameter table, escapes patched from the side channel."""
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
        carry, got = decode(carry, rows, dev)
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
    rows = torch.zeros((1, max(n_lanes, 1)), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_lanes"):
        dr.rans_decode_phase(words, x, ptr, n_lanes, 1, rows,
                             {"row_params": torch.zeros((2, 6))}, True)


def test_encode_scan_matches_host_loop():
    """The encode scan (its plain version, through the wrapper) against a
    per-lane Python reference of the rans16 step (emit iff x >= freq <<
    16): one image of 8 lanes, the y section in place, no z."""
    rng = np.random.default_rng(9)
    S, L = 40, 8
    freq = rng.integers(1, 1 << 12, (S, L))
    start = rng.integers(0, (1 << 16) - freq)
    i32 = torch.int32
    x, words, masks = dr.rans_encode_scan(
        torch.zeros((1, 0), dtype=i32), torch.zeros((1, 0), dtype=i32),
        torch.from_numpy(start.reshape(1, -1)).to(i32),
        torch.from_numpy((freq - 1).reshape(1, -1)).to(i32), L, 1)
    assert masks.shape == (S, 1, 1) and masks.dtype == i32
    emits = dr.masks_to_emits(masks, L)
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


def _bisect_slots(cf, n_steps, rows, tables, parametric):
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
            torch.zeros(n, dtype=torch.int32), 1, n_steps, rows, tables,
            parametric)
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
    want = _bisect_slots(cf, tables["n_steps"], idx.to(torch.int32)[None],
                         {"row_params": rp}, True)
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
    want = _bisect_slots(cf, tables["z_steps"], rows[None], tabs, False)
    _assert_same_slots(got, want)
    assert bool(got[3].any())


def test_kary_search_on_tiny_codec_payload(monkeypatch):
    """The TINY codec's own streams: every phase that ``decompress``
    decodes is decoded again step by step with the T-way search for T in
    {2, 4, 8}; symbols, escape flags and the carry equal the bisection's."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops.select_rows import select_rows_plain
    from mlic_tpu_torch.weights import init_params

    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    codec = Codec(model, n_lanes=16, device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3),
                                          dtype=np.uint8)
    enc = codec.compress(x)
    bisect = dr.rans_decode_phase
    phases = []

    def both(words, x, img_ptr, n_lanes, n_steps, rows, tables, parametric):
        ref = bisect(words, x, img_ptr, n_lanes, n_steps, rows, tables,
                     parametric)
        cols = select_rows_plain(rows, tables["row_params"]) if parametric \
            else None
        for group in (2, 4, 8):
            xs, ptr = x, img_ptr
            for s in range(rows.shape[0]):
                cf = (xs & 0xFFFF).to(torch.int32)
                sym, start, freq, esc = dr.decode_slot_plain(
                    cf, group, n_steps,
                    cols_s=cols[:, s] if parametric else None,
                    row=None if parametric else rows[s],
                    cdf_rows=tables["cdf_rows"],
                    max_value=tables["max_value"], offsets=tables["offsets"])
                assert torch.equal(sym, ref[0][s]) and torch.equal(esc, ref[1][s])
                xs = (freq.long() * (xs >> 16) + cf - start) & 0xFFFFFFFF
                xs, ptr = dr._renorm_global_plain(xs, ptr, words)
            assert torch.equal(xs, ref[2]) and torch.equal(ptr, ref[3])
        phases.append("parametric" if parametric else "rows")
        return ref

    monkeypatch.setattr(dr, "rans_decode_phase", both)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert phases[0] == "rows" and \
        phases.count("parametric") == len(phases) - 1 > 0


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


# --------------------------------------------------------------------------
# The encode back end (K3 + K6): position layout, ranks, divide, refusals
# --------------------------------------------------------------------------
def _sections(tables, sym, idx, z):
    """The prep's z and y sections, as ``encode_rans_v4`` computes them."""
    sym_t, idx_t, z_t = (torch.from_numpy(a) for a in (sym, idx, z))
    return dr.rans_encode_prep(sym_t, idx_t, z_t, tables["dev"],
                               tables["n_g"], N_CH), sym_t, z_t


def _old_layout(az, ay, n_lanes, pad_value):
    """The layout before the back end read the sections in place: every
    phase through ``phase_order``, concatenated."""
    return torch.cat([dr.phase_order(az, n_lanes, pad_value)] + [
        dr.phase_order(ay[:, k * N_PER:(k + 1) * N_PER], n_lanes, pad_value)
        for k in range(N_PHASES)], 0)


@pytest.mark.parametrize("n_lanes", [1, 16, 32])
def test_back_end_equals_old_composition(tables, n_lanes):
    """The plain back end (``rans_encode_scan`` + ``rans_encode_compact`` on
    the sections) equals phase_order + ``rans_encode_scan_plain`` +
    ``compact_streams_global``; 100 symbols a phase and 48 of z leave pads
    at 16 and 32 lanes."""
    sym, idx, z = _payload(tables, 0.03, 11)
    ((st_z, fm_z, esc_z), (st_y, fm_y, esc_y)), sym_t, z_t = _sections(
        tables, sym, idx, z)
    got_scan = dr.rans_encode_scan(st_z, fm_z, st_y, fm_y, n_lanes, N_PHASES)
    got = dr.rans_encode_compact(*got_scan, esc_z, z_t, esc_y, sym_t,
                                 n_lanes, N_PHASES)
    start16 = dr.u16_bits(_old_layout(st_z, st_y, n_lanes, dr._PAD_START))
    freqm1 = dr.u16_bits(_old_layout(fm_z, fm_y, n_lanes, dr._PAD_FREQM1))
    ref_scan = dr.rans_encode_scan_plain(start16, freqm1, n_lanes)
    ref = dr.compact_streams_global(
        *ref_scan, _old_layout(esc_z, esc_y, n_lanes, False),
        _old_layout(z_t, sym_t, n_lanes, 0), B)
    for g, r in zip(got_scan, ref_scan):
        assert torch.equal(g, r)
    n = int(ref["img_n"].sum())
    assert torch.equal(got["buf"][:n], ref["buf"][:n])
    for key in ("img_n", "ebuf", "ecount"):
        assert torch.equal(got[key], ref[key])
    assert int(ref["ecount"].sum()) > 0
    if n_lanes > 1:
        assert bool((start16.shape[0] * n_lanes * B
                     > B * (z.shape[1] + sym.shape[1])))     # pads occur


@pytest.mark.parametrize("n_lanes,n_z,n_per",
                         [(1, 7, 5), (16, 48, 100), (32, 0, 33), (64, 65, 64)])
def test_encode_sources_match_phase_order(n_lanes, n_z, n_per):
    """``encode_sources_plain`` (K3's and K6's index arithmetic) lays the
    sections out as phase_order + concatenation does, pads included."""
    n_phases, b = 3, 3
    z = torch.arange(b * n_z, dtype=torch.int32).reshape(b, n_z)
    y = 10_000 + torch.arange(b * n_phases * n_per,
                              dtype=torch.int32).reshape(b, -1)
    got = dr.encode_layout_plain(z, y, n_lanes, n_phases, -1)
    want = torch.cat([dr.phase_order(z, n_lanes, -1)] + [
        dr.phase_order(y[:, k * n_per:(k + 1) * n_per], n_lanes, -1)
        for k in range(n_phases)], 0)
    assert torch.equal(got, want)
    assert got.shape[0] == dr.encode_steps(n_z, n_per, n_phases, n_lanes)[2]


@pytest.mark.parametrize("n_lanes", [1, 16, 32, 64])
def test_word_positions_match_cumsum_ranks(n_lanes):
    """K6's rank arithmetic (``word_positions_plain``: mask popcount scans)
    places every emitted word where the cumsum of
    ``compact_streams_global`` does, and counts the same img_n."""
    rng = np.random.default_rng(40 + n_lanes)
    S, b = 9, 3
    emits = torch.from_numpy(rng.random((S, b * n_lanes)) < 0.4)
    emits[:, :n_lanes] = True            # a full word: bit 31 set at 32+
    masks = dr.emits_to_masks(emits, n_lanes)
    assert torch.equal(dr.masks_to_emits(masks, n_lanes), emits)
    pos, img_n = dr.word_positions_plain(masks, n_lanes)
    em_i = emits.reshape(S, b, n_lanes).permute(1, 0, 2).reshape(b, -1)
    e = em_i.long()
    n = e.sum(1) + 2 * n_lanes
    want = (torch.cumsum(n, 0) - n)[:, None] + 2 * n_lanes \
        + torch.cumsum(e, 1) - e
    want = torch.where(em_i, want, -1).reshape(b, S, n_lanes) \
        .permute(1, 0, 2).reshape(S, -1)
    assert torch.equal(pos, want) and torch.equal(img_n, n)


@pytest.mark.parametrize("slack", [1, 2, 15])
def test_divmod_magic_exact_for_every_frequency(slack):
    """K3's reciprocal divide equals // and % for every freq in [1, 2^16]
    at the edges of its quotients (0, freq - 1, freq, the largest
    multiples below 2^32 and one either side, x < freq << 16) and at
    seeded x < 2^32, with the reciprocal anywhere in its stated range."""
    d = torch.arange(1, (1 << 16) + 1, dtype=torch.int64)
    top = ((1 << 32) - 1) // d
    rng = np.random.default_rng(50)
    cols = [torch.zeros_like(d), d - 1, d, d + 1, top * d - 1, top * d,
            torch.full_like(d, (1 << 32) - 1), (d << 16) - 1,
            ((d << 16) - 1).clamp(max=(1 << 32) - 1) - d,
            torch.from_numpy(rng.integers(0, 1 << 32, d.shape[0])),
            torch.from_numpy(rng.integers(0, 1 << 32, d.shape[0]))]
    x = torch.stack(cols, 1).clamp(0, (1 << 32) - 1)
    dd = d[:, None].expand_as(x)
    q, r = dr.divmod_magic_plain(x, dd, slack)
    assert torch.equal(q, x // dd) and torch.equal(r, x % dd)


def _good_sections(b=2, n_z=12, n_y=24):
    i = torch.zeros((b, n_z), dtype=torch.int32)
    j = torch.zeros((b, n_y), dtype=torch.int32)
    return i, i.clone(), j, j.clone()


@pytest.mark.parametrize("case", ["lanes_0", "lanes_3", "lanes_2048",
                                  "int16", "batch", "phases", "strided",
                                  "meta"])
def test_encode_wrappers_refuse(case):
    """K3's and K6's wrappers refuse, on any device and before any launch,
    lane counts, dtypes, shapes and layouts the kernels cannot take, and
    a device that is neither the CPU nor CUDA."""
    z, fz, y, fy = _good_sections()
    lanes, phases = 4, 3
    if case.startswith("lanes"):
        lanes = int(case.split("_")[1])
    elif case == "int16":
        y = y.to(torch.int16)
    elif case == "batch":
        y = torch.zeros((3, 24), dtype=torch.int32)
    elif case == "phases":
        phases = 5
    elif case == "strided":
        y = torch.zeros((24, 2), dtype=torch.int32).t()
    elif case == "meta":
        z, fz, y, fy = (t.to("meta") for t in (z, fz, y, fy))
    err = TypeError if case == "int16" else ValueError
    with pytest.raises(err):
        dr.rans_encode_scan(z, fz, y, fy, lanes, phases)
    # the compaction checks the same geometry and its own inputs' shapes
    x, words, masks = dr.rans_encode_scan(*_good_sections(), 4, 3)
    esc_z, esc_y = torch.zeros((2, 12), dtype=torch.bool), \
        torch.zeros((2, 24), dtype=torch.bool)
    with pytest.raises(err):
        dr.rans_encode_compact(x, words, masks, esc_z.to(z.device), z,
                               esc_y.to(y.device) if case != "batch"
                               else torch.zeros((3, 24), dtype=torch.bool),
                               y, lanes, phases)
    with pytest.raises(ValueError):
        dr.rans_encode_compact(x, words, masks[:-1], esc_z,
                               *_good_sections()[:1], esc_y,
                               _good_sections()[2], 4, 3)


# --------------------------------------------------------------------------
# K7 (the prep), K4's rows, K6's items (the plain versions)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_payload():
    """A seeded MLICPP_TINY batch (2 x 64x128, random weights) through
    ``analyze`` and the encode pass, 3% of y and z symbols pushed out of
    their rows' support (escapes), and the codec's tables."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.weights import init_params

    model = get_model("MLICPP_TINY")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    codec = Codec(model, n_lanes=16, device="cpu")
    codec.update()
    rng = np.random.default_rng(60)
    x = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    with torch.no_grad():
        y, z = model.analyze(torch.from_numpy(x))
        _, sym, idx = model.codec_encode_pass(y, z)
    sym, z = sym.numpy().copy(), z.reshape(2, -1).numpy().copy()
    for a, hi in ((sym, 4000), (z, 400)):
        m = rng.random(a.shape) < 0.03
        a[m] = rng.choice([-1, 1], int(m.sum())) * rng.integers(
            hi // 2, hi, int(m.sum()))
    return codec, torch.from_numpy(sym), idx, torch.from_numpy(z)


def test_encode_prep_plain_matches_composition_and_jax(tiny_payload):
    """K7's plain path (the wrapper on CPU tensors) equals the composition
    it replaced on the card (K1 and K2 through their wrappers) and the JAX
    package's ``analytic_start_freq`` / ``_gather_start_freq`` bit for
    bit: everywhere in z (integer tables), and in y wherever the port's
    parametric table agrees with XLA's at the slot and the next (the
    tables differ in a few entries by design; test_torch_parametric.py)."""
    import jax.numpy as jnp

    from mlic_tpu.entropy import device_rans as jdr
    from mlic_tpu.entropy import parametric as jp
    from mlic_tpu_torch.ops.select_rows import select_rows

    codec, sym, idx, z = tiny_payload
    t = codec.tables
    n_ch = codec.model.cfg.N
    args = (sym, idx, z, t, codec.z_rows_base, n_ch)
    got = dr.rans_encode_prep(*args)
    old = dr.encode_prep_plain(*args, select=select_rows, cdf=tp.eval_cdf)
    for g, o in zip(got, old):
        for a, b in zip(g, o):
            assert torch.equal(a, b)
    (zs, zf, ze), (ys, yf, ye) = got
    assert int(ze.sum()) > 0 and int(ye.sum()) > 0

    jt = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    z_rows = codec.z_rows_base + np.arange(z.shape[1]) % n_ch
    js, jf, je = jdr._gather_start_freq(
        jnp.asarray(z.numpy()), jnp.asarray(np.broadcast_to(z_rows, z.shape)),
        jt)
    np.testing.assert_array_equal(zs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(zf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ze.numpy(), np.asarray(je))

    js, jf, je = jdr.analytic_start_freq(jnp.asarray(sym.numpy()),
                                         jnp.asarray(idx.numpy()),
                                         jt["row_params"])
    np.testing.assert_array_equal(ye.numpy(), np.asarray(je))
    n_g = codec.z_rows_base
    lengths = t["max_value"].numpy()[:n_g] + 2
    port_tab = t["cdf_rows"].numpy()[:n_g, :lengths.max()]
    differs = port_tab != jp.generate_tables(t["row_params"].numpy(), lengths)
    r = idx.numpy()
    L = t["row_params"].numpy()[r, 5].astype(np.int64)
    v = sym.numpy() - (-((L - 1) >> 1))
    slot = np.where(ye.numpy(), L, v)
    expect = differs[r, slot] | differs[r, slot + 1]
    seen = (ys.numpy() != np.asarray(js)) | (yf.numpy() != np.asarray(jf))
    np.testing.assert_array_equal(seen, expect)


def _old_decode_phase_cols(words, x, img_ptr, n_steps, cols):
    """The parametric plain decode as it read K1's six column planes
    [6, S, B*n_lanes] before K4 took row indexes (kept as the reference)."""
    S = cols.shape[1]
    sym = torch.empty((S, x.shape[0]), dtype=torch.int32)
    esc_out = torch.empty((S, x.shape[0]), dtype=torch.bool)
    for s in range(S):
        cf = (x & 0xFFFF).to(torch.int32)
        lo, v_lo = torch.zeros_like(cf), torch.zeros_like(cf)
        pm, pb, pA, pC, pB, pL = cols[:, s]
        mv = pL.to(torch.int32)
        esc = cf == 0xFFFF
        hi, v_hi = mv, torch.full_like(cf, 0xFFFF)
        for _ in range(n_steps):
            guard = (hi - lo) > 1
            mid = (lo + hi) >> 1
            v_mid = tp.eval_cdf_plain(mid, pm, pb, pA, pC, pB)
            take = (v_mid <= cf) & guard
            keep = guard & ~take
            lo, v_lo = torch.where(take, mid, lo), torch.where(take, v_mid, v_lo)
            hi, v_hi = torch.where(keep, mid, hi), torch.where(keep, v_mid, v_hi)
        start = torch.where(esc, 0xFFFF, v_lo).long()
        freq = torch.where(esc, 1, v_hi - v_lo).long()
        sym[s] = lo - ((mv - 1) >> 1)
        esc_out[s] = esc
        x = (freq * (x >> 16) + (x & 0xFFFF) - start) & 0xFFFFFFFF
        x, img_ptr = dr._renorm_global_plain(x, img_ptr, words)
    return sym, esc_out, x, img_ptr


@pytest.mark.parametrize("n_lanes,n_img", [(16, 3), (64, 2)])
def test_decode_phase_plain_rows_equals_cols_form(tables, n_lanes, n_img):
    """``rans_decode_phase_plain`` with row indexes and the row-parameter
    table equals the parametric decode on K1's column planes, on seeded
    states (some at the escape slot), words and rows (out-of-table rows
    select row 0, as K1 does)."""
    from mlic_tpu_torch.ops.select_rows import select_rows_plain

    rp = tables["dev"]["row_params"]
    rng = np.random.default_rng(70 + n_lanes)
    S, BL = 6, n_img * n_lanes
    words = torch.from_numpy(rng.integers(0, 1 << 16, 8 * S * BL)
                             .astype(np.uint16).view(np.int16))
    x = torch.from_numpy(rng.integers(1 << 16, 1 << 32, BL))
    x[::5] |= 0xFFFF                     # cf = 2^16 - 1: the escape slot
    ptr = torch.from_numpy((np.arange(n_img) * 4 * S * n_lanes)
                           .astype(np.int32))
    rows = torch.from_numpy(rng.integers(-2, rp.shape[0] + 2, (S, BL))
                            .astype(np.int32))
    got = dr.rans_decode_phase_plain(words, x, ptr, n_lanes,
                                     tables["n_steps"], rows,
                                     {"row_params": rp}, True)
    want = _old_decode_phase_cols(words, x, ptr, tables["n_steps"],
                                  select_rows_plain(rows, rp))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any())


@pytest.mark.parametrize("n_lanes", [1, 16, 32, 512, 1024])
def test_compact_plan_tiles_every_step(n_lanes):
    """K6's items: one mask word a thread (256 a block), runs of steps that
    tile each image's steps in order, and one empty item for an image of
    no steps."""
    W = -(-n_lanes // 32)
    for S in (0, 1, 7, 255, 256, 257, 498, 3100):
        per, ipi = dr.compact_plan(n_lanes, S)
        assert per * W == dr.COMPACT_THREADS
        runs = [(i * per, min((i + 1) * per, S)) for i in range(ipi)]
        assert ipi == max(-(-S // per), 1)
        assert all(lo < hi for lo, hi in runs) or S == 0
        assert sum(hi - lo for lo, hi in runs) == S
        assert all(runs[i][1] == runs[i + 1][0] for i in range(ipi - 1))


@pytest.mark.parametrize("n_lanes", [1, 16, 64])
def test_compact_items_match_compact_streams_global(n_lanes):
    """K6's item arithmetic (``compact_items_plain``): every item's
    exclusive prefix is the number of words and escapes of all images
    before its first position, and the image totals are
    ``compact_streams_global``'s img_n and ecount."""
    rng = np.random.default_rng(80 + n_lanes)
    S, B = 600 if n_lanes == 1 else 40, 3
    emits = torch.from_numpy(rng.random((S, B * n_lanes)) < 0.4)
    esc = torch.from_numpy(rng.random((S, B * n_lanes)) < 0.05)
    masks = dr.emits_to_masks(emits, n_lanes)
    got = dr.compact_items_plain(masks, esc, n_lanes)
    words = torch.zeros((S, B * n_lanes), dtype=torch.int16)
    sym = torch.zeros((S, B * n_lanes), dtype=torch.int32)
    x = torch.zeros(B * n_lanes, dtype=torch.int64)
    ref = dr.compact_streams_global(x, words, masks, esc, sym, B)
    assert torch.equal(got["img_n"].int(), ref["img_n"])
    assert torch.equal(got["ecount"].int(), ref["ecount"])
    per, ipi = dr.compact_plan(n_lanes, S)

    def per_image(a):
        return a.reshape(S, B, n_lanes).permute(1, 0, 2).reshape(B, -1).long()
    flat = torch.stack([per_image(emits).reshape(-1),
                        per_image(esc).reshape(-1)], 1)
    starts = torch.cat([torch.zeros((1, 2), dtype=torch.int64),
                        torch.cumsum(flat, 0)])
    first = [b * S * n_lanes + min(j * per, S) * n_lanes
             for b in range(B) for j in range(ipi)]
    assert torch.equal(got["exclusive"], starts[first])
    assert torch.equal(got["aggregate"].sum(0), flat.sum(0))


def test_compact_status_tags():
    """K6's status tags: epoch << 2 | flag, 62 bits of epoch; a tag of
    another epoch, or zeroed memory (flag 0), never reads as ready."""
    epochs = [0, 1, 2, 3, 4, (1 << 40) + 7, (1 << 62) - 1]
    tags = {(e, f): dr.compact_status_tag(e, f) for e in epochs
            for f in (dr.STATUS_AGGREGATE, dr.STATUS_PREFIX)}
    assert len(set(tags.values())) == len(tags)
    for (e, f), t in tags.items():
        assert 0 < t < 1 << 64 and t >> 2 == e and t & 3 == f
    assert all(t & 3 for t in tags.values())


@pytest.mark.parametrize("n_lanes,n_z,n_per,n_phases",
                         [(1, 7, 5, 3), (16, 48, 100, 4), (64, 65, 33, 2)])
def test_compact_plain_matches_jax_on_ragged_geometries(n_lanes, n_z, n_per,
                                                        n_phases):
    """The plain back end through K3's and K6's wrappers (CPU tensors) on
    seeded sections with pads in both (one lane, 16 and 64 lanes) is
    byte-identical to the JAX package's ``compact_streams_global`` on the
    same scan outputs in position order."""
    import jax.numpy as jnp

    from mlic_tpu.entropy import device_rans as jdr

    rng = np.random.default_rng(90 + n_lanes)
    B = 3
    i32 = torch.int32

    def sections(n):
        freq = rng.integers(1, 1 << 12, (B, n))
        start = rng.integers(0, (1 << 16) - freq)
        return (torch.from_numpy(start).to(i32),
                torch.from_numpy(freq - 1).to(i32),
                torch.from_numpy(rng.random((B, n)) < 0.05),
                torch.from_numpy(rng.integers(-5000, 5000, (B, n))).to(i32))
    zs, zf, ze, zsym = sections(n_z)
    ys, yf, ye, ysym = sections(n_phases * n_per)
    scan = dr.rans_encode_scan(zs, zf, ys, yf, n_lanes, n_phases)
    got = dr.rans_encode_compact(*scan, ze, zsym, ye, ysym, n_lanes, n_phases)
    x, words, masks = scan
    emits = dr.masks_to_emits(masks, n_lanes)
    esc = dr.encode_layout_plain(ze, ye, n_lanes, n_phases, False)
    sym = dr.encode_layout_plain(zsym, ysym, n_lanes, n_phases, 0)
    ref = jdr.compact_streams_global(
        jnp.asarray(x.numpy().astype(np.uint32)),
        jnp.asarray(words.numpy().view(np.uint16)), jnp.asarray(emits.numpy()),
        jnp.asarray(esc.numpy()), jnp.asarray(sym.numpy()), B)
    n, ne = int(np.sum(ref["img_n"])), int(np.sum(ref["ecount"]))
    np.testing.assert_array_equal(got["buf"][:n].numpy().view(np.uint16),
                                  np.asarray(ref["buf"])[:n])
    np.testing.assert_array_equal(got["img_n"].numpy(), np.asarray(ref["img_n"]))
    np.testing.assert_array_equal(got["ebuf"][:ne].numpy(),
                                  np.asarray(ref["ebuf"])[:ne])
    np.testing.assert_array_equal(got["ecount"].numpy(),
                                  np.asarray(ref["ecount"]))
    assert ne > 0 and bool(esc.sum() > 0)
