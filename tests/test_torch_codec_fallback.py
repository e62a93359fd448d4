"""The fallbacks of the port's ``Codec.update``, on the CPU (MLICPP_TINY,
seeded weights, [2, 64, 64, 3], 16 lanes; every comparison exact).

Each check of the parametric table is forced to fail by replacing the
port's check function: ``self_check_encode`` alone takes fallback A (the
table stays, y's entries are gathered from its rows), ``validate_tables``
or ``self_check`` fallback B (the host-built tables, y coded by its
integer rows).  ``update`` codes on, sets the JAX package's attributes and
warns once; the round trips are bit-exact; A writes the unforced codec's
bytes; every ``update`` generates and checks the table anew, so a failed
check is retried.  Then B's pieces against the JAX package's: the y symbols that the
row-mode decode (K4's plain version) reads from a v3 stream against the
JAX LUT decode (``make_decoder(fmt="global")`` over ``device_tables``),
the gathered prep against ``_gather_start_freq``, the T-way search
against the bisection at the rows' width of 3,136, and the VBR twin under
B at two levels.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlic_tpu.entropy.device_rans import _gather_start_freq
from mlic_tpu.entropy.device_rans import device_tables as jax_device_tables
from mlic_tpu.entropy.device_rans import make_decoder as jax_make_decoder
from mlic_tpu_torch.codec import Codec
from mlic_tpu_torch.entropy import device_rans as dr
from mlic_tpu_torch.entropy import parametric
from mlic_tpu_torch.entropy.rans.coder import encode_global
from mlic_tpu_torch.entropy.stream import parse_global
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.weights import init_params

SHAPE = (2, 64, 64, 3)
N_LANES = 16
FORCED = [("self_check_encode", "A"), ("validate_tables", "B"),
          ("self_check", "B")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (the
    suite's xdist workers share the cores; see test_torch_codec.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name="MLICPP_TINY", **kw):
    m = get_model(name, **kw)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    return m


@pytest.fixture(scope="module")
def base():
    """The unforced codec and its compress result."""
    codec = Codec(_model(), n_lanes=N_LANES, device="cpu")
    codec.update()
    x = np.random.default_rng(4).random(SHAPE, dtype=np.float32)
    return codec, x, codec.compress(x)


def _forced(monkeypatch, check: str, model, **codec_kw):
    """A codec whose ``update`` saw ``check`` fail by 5; returns it and the
    warnings ``update`` gave."""
    monkeypatch.setattr(parametric, check, lambda *a, **k: 5)
    codec = Codec(model, n_lanes=N_LANES, device="cpu", **codec_kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert codec.update() is True
    return codec, [w for w in caught if "Codec.update" in str(w.message)]


@pytest.mark.parametrize("check,fallback", FORCED)
def test_update_falls_back_and_codes_on(base, monkeypatch, check, fallback):
    codec0, x, enc0 = base
    codec, caught = _forced(monkeypatch, check, codec0.model)
    assert len(caught) == 1 and check in str(caught[0].message)
    assert "5 " in str(caught[0].message)
    assert codec.analytic_enc_rows == 0
    assert codec.parametric == (fallback == "A")
    assert ("row_params" in codec.tables) == (fallback == "A")
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    assert torch.equal(enc["y_hat"], enc0["y_hat"])
    if fallback == "A":
        assert enc["strings"] == enc0["strings"]
        return
    assert codec.tables["cdf_rows"].shape[1] == 3136
    assert codec.n_steps == 12
    monkeypatch.setenv("MLIC_UNIFIED_Z", "0")
    v3, _ = _forced(monkeypatch, check, codec0.model)
    enc3 = v3.compress(x)
    assert all(enc3["strings"][1])
    dec3 = v3.decompress(enc3["strings"], enc3["shape"])
    assert torch.equal(dec3["y_hat"], enc3["y_hat"])
    assert torch.equal(enc3["y_hat"], enc0["y_hat"])


def test_every_update_checks_anew(base, monkeypatch):
    """No verdict outlives its ``update``: a table rejected once is
    generated and checked again by the next ``update``, which codes
    parametrically once the check passes; ``update(force=False)`` keeps
    the tables it has and runs nothing."""
    codec0, x, enc0 = base
    runs = []
    real, check = parametric.generate_tables, parametric.self_check
    monkeypatch.setattr(parametric, "generate_tables",
                        lambda *a, **k: runs.append(1) or real(*a, **k))
    codec, caught = _forced(monkeypatch, "self_check", codec0.model)
    assert len(caught) == 1 and not codec.parametric
    monkeypatch.setattr(parametric, "self_check", check)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert codec.update() is True
        assert codec.update(force=False) is False
    assert len(runs) == 2
    assert codec.parametric and codec.analytic_enc_rows > 0
    assert codec.compress(x)["strings"] == enc0["strings"]


@pytest.fixture(scope="module")
def b_tables():
    """Fallback B's combined device tables and host rows."""
    with pytest.MonkeyPatch.context() as mp:
        codec, _ = _forced(mp, "validate_tables", _model())
    return codec


def _random_symbols(rng, n: int, n_rows: int, lengths, offsets):
    """Symbols at random rows with 3% escapes (both signs)."""
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    mv = lengths[rows] - 2
    sym = offsets[rows] + rng.integers(0, mv)
    esc = np.zeros(n, bool)
    esc[rng.choice(n, max(n * 3 // 100, 2), replace=False)] = True
    big = rng.choice([-1, 1], n) * (mv + 1 + rng.integers(0, 100, n))
    return np.where(esc, big, sym).astype(np.int32), rows, esc


def test_b_row_decode_equals_jax_lut_decode(b_tables):
    """A v3 stream of 384 symbols on 16 lanes over B's rows: the port's
    row-mode decode (K4's plain version, 12 levels) returns the JAX LUT
    decode's symbols, and both return the coded ones."""
    codec = b_tables
    _, lengths, offsets, table = codec._gauss
    rng = np.random.default_rng(7)
    sym, rows, esc = _random_symbols(rng, 24 * N_LANES, len(lengths) - 1,
                                     lengths, offsets)
    stream = encode_global(sym, rows, N_LANES, table, lengths, offsets)
    _, words, esc_vals = parse_global(stream)
    init, decode = dr.make_decoder(
        torch.from_numpy(words.view(np.int16).copy()), codec.n_steps,
        torch.from_numpy(esc_vals.copy()), torch.zeros(1, dtype=torch.int32),
        N_LANES)
    _, got = decode(init(torch.zeros(1, dtype=torch.int32)),
                    torch.from_numpy(rows.reshape(-1, N_LANES)),
                    codec.tables, n_steps_row=codec.n_steps)
    jinit, jdecode = jax_make_decoder(
        jnp.asarray(words.astype(np.int32)), 12, jnp.asarray(esc_vals),
        jnp.zeros(1, jnp.int32), fmt="global", n_lanes=N_LANES)
    _, want = jdecode(jinit(jnp.zeros(1, jnp.int32)), jnp.asarray(rows),
                      jax_device_tables(table, lengths, offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), sym)
    assert esc.sum() >= 2


def test_gather_prep_equals_jax(b_tables):
    codec = b_tables
    t = codec.tables
    n_rows = t["cdf_rows"].shape[0]
    lengths = t["max_value"].numpy() + 2
    sym, rows, _ = _random_symbols(np.random.default_rng(8), 2 * 300,
                                   n_rows, lengths, t["offsets"].numpy())
    sym_t = torch.from_numpy(sym.reshape(2, -1))
    rows_t = torch.from_numpy(rows.reshape(2, -1))
    _, got = dr.rans_encode_prep(sym_t, rows_t, sym_t[:, :0], t,
                                 y_gather=True)
    plain = dr.gather_start_freq(sym_t, rows_t, t)
    jt = {k: jnp.asarray(t[k].numpy()) for k in ("cdf_rows", "max_value",
                                                 "offsets")}
    want = _gather_start_freq(jnp.asarray(sym_t.numpy()),
                              jnp.asarray(rows_t.numpy()), jt)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert got[2].any()


@pytest.mark.parametrize("group", [4, 8])
def test_kary_search_equals_bisection_at_3136(b_tables, group):
    t = b_tables.tables
    assert t["cdf_rows"].shape[1] == 3136
    rng = np.random.default_rng(group)
    n = 4096
    n_g = b_tables.z_rows_base
    row = torch.from_numpy(rng.integers(0, n_g, n).astype(np.int32))
    cf = torch.from_numpy(rng.integers(0, 1 << 16, n).astype(np.int32))
    sym, start, freq, esc = dr.decode_slot_plain(
        cf, group, 12, row=row, cdf_rows=t["cdf_rows"],
        max_value=t["max_value"], offsets=t["offsets"])
    rows_np = t["cdf_rows"].numpy()
    lengths = t["max_value"].numpy() + 2
    slot = np.array([np.searchsorted(rows_np[r, :lengths[r]], c, "right") - 1
                     for r, c in zip(row.numpy(), cf.numpy())])
    r = row.numpy()
    np.testing.assert_array_equal(sym.numpy(), slot + t["offsets"].numpy()[r])
    np.testing.assert_array_equal(start.numpy(), rows_np[r, slot])
    np.testing.assert_array_equal(freq.numpy(),
                                  rows_np[r, slot + 1] - rows_np[r, slot])
    np.testing.assert_array_equal(esc.numpy(), slot == lengths[r] - 2)


def test_vbr_twin_under_fallback_b(monkeypatch):
    """MLICPP_TINY_VBR with the variable-step bottleneck under B at its
    lowest and top levels: bit-exact, every cached step at one ratcheted
    width."""
    m = _model("MLICPP_TINY_VBR", vr_entbttlnck=True)
    codec, caught = _forced(monkeypatch, "validate_tables", m)
    assert len(caught) == 1 and not codec.parametric
    x = np.random.default_rng(5).random(SHAPE, dtype=np.float32)
    for s in (0, len(m.cfg.gain_init) - 1):
        enc = codec.compress(x, s=s)
        dec = codec.decompress(enc["strings"], enc["shape"], s=s)
        assert torch.equal(enc["y_hat"], dec["y_hat"]), s
        assert torch.equal(enc["x_hat"], dec["x_hat"]), s
    widths = {t["cdf_rows"].shape[1] for t in codec._by_step.values()}
    assert len(codec._by_step) >= 2 and widths == {codec._width}
    assert codec._width >= 3136
