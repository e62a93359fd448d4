"""The port's checkpoints: the orbax reader against orbax and tensorstore
(the repo's two trained checkpoints, a fresh one the JAX package writes,
and stores laid out to exercise B-tree interior nodes and zarr chunking),
the training-state manager, partial loads, and the train CLI's warm start
from an orbax directory."""

import json
import os

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from mlic_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.utils import checkpoint as ck
from mlic_tpu_torch.weights import from_flax, init_params, load_checkpoint, to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "ckpts", "bench_default")
BENCH_L = os.path.join(ROOT, "ckpts", "bench_default_MLICPP_L")


def _flat(tree):
    """keystr -> numpy array; a PRNG key as its key data (how it is
    stored)."""
    out = {}
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if jax.dtypes.issubdtype(getattr(v, "dtype", None),
                                 jax.dtypes.prng_key):
            v = jax.random.key_data(v)
        out[jax.tree_util.keystr(p)] = np.asarray(v)
    return out


def _bit_equal(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, want in ref.items():
        got = ours[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k


def test_read_orbax_bench_default_bit_equal_to_orbax():
    ours = _flat(ck.read_orbax(BENCH))
    ref = _flat(ocp.PyTreeCheckpointer().restore(BENCH))
    assert len(ref) == 670
    _bit_equal(ours, ref)
    assert sum(v.size for v in ours.values()) == 11_794_180
    model = get_model("MLICPP_S")
    res = model.load_state_dict(load_checkpoint(BENCH), strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_read_orbax_mlicpp_l_bfloat16():
    """Key set against _METADATA, shapes and stored dtypes against orbax's
    metadata, and one array bit-equal (bfloat16 widened to f32)."""
    arrays = ck.orbax_arrays(BENCH_L)
    with open(os.path.join(BENCH_L, "_METADATA")) as f:
        keys = {".".join(eval(k)) for k in json.load(f)["tree_metadata"]}
    assert set(arrays) == keys and len(keys) == 1215
    meta = jax.tree_util.tree_flatten_with_path(
        ocp.PyTreeCheckpointer().metadata(BENCH_L).item_metadata,
        is_leaf=lambda m: hasattr(m, "shape") and hasattr(m, "dtype"))[0]
    assert len(meta) == 1215
    for path, m in meta:
        zarray = arrays[".".join(k.key for k in path)][0]
        assert tuple(zarray["shape"]) == tuple(m.shape), path
        assert zarray["dtype"] == str(m.dtype) == "bfloat16", path
    name = "params.g_a.rbs1.gdn.gamma"
    want = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{BENCH_L}/",
        "path": name + "/"}}).result().read().result()
    got = ck.read_orbax(BENCH_L)["params"]["g_a"]["rbs1"]["gdn"]["gamma"]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == np.asarray(want).astype(np.float32).tobytes()


@pytest.fixture(scope="module")
def tiny_orbax(tmp_path_factory):
    """A TINY training checkpoint written by the JAX package's
    CheckpointManager: params, Adam state, step and a PRNG key."""
    model = get_model("MLICPP_TINY")
    params = to_flax(init_params(model, torch.Generator().manual_seed(3)))
    tree = {"step": np.int32(7), "params": params,
            "opt_state": optax.adam(1e-4).init(params),
            "rng": jax.random.key(5)}
    d = tmp_path_factory.mktemp("jax_ckpt")
    JaxCheckpointManager(str(d)).save("7", tree)
    return str(d / "checkpoint_7"), params


def test_read_orbax_fresh_checkpoint_bit_equal(tiny_orbax):
    path, params = tiny_orbax
    ours = ck.read_orbax(path)
    _bit_equal(_flat(ours), _flat(ocp.StandardCheckpointer().restore(path)))
    assert int(ours["step"]) == 7
    _bit_equal(_flat(ours["params"]), _flat(params))


def test_train_cli_pretrained_loads_every_leaf(tiny_orbax, tmp_path, capsys):
    from mlic_tpu_torch.tools import train as cli
    path, params = tiny_orbax
    n = len(jax.tree_util.tree_leaves(params))
    cli.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic", "--steps",
              "1", "--batch-size", "1", "--patch-size", "64",
              "--ckpt-dir", str(tmp_path), "--pretrained", path])
    assert f"warm-started {n} of {n} parameters" in capsys.readouterr().out


def test_read_ocdbt_interior_nodes(tmp_path):
    """A store whose B-tree has interior nodes (small nodes), values inline
    and in data files, written in one transaction by tensorstore."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    txn = ts.Transaction()
    want = {}
    for i in range(150):
        key = f"params.layer_{i:03d}.kernel/0.{i % 3}".encode()
        want[key] = (b"v%03d" % i) * (1 + i % 7)
        kv.with_transaction(txn)[key] = want[key]
    txn.commit_async().result()
    height = ck._latest_root(str(tmp_path))[0]
    assert height >= 2
    assert ck.read_ocdbt(str(tmp_path)) == want


def test_zarr_chunks_fill_and_bfloat16(tmp_path):
    """Arrays split over several chunks (ragged at the edge), with chunks
    never written (the fill value), in f32, int32 and bfloat16."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.default_rng(0)
    for name, dtype in (("a", "float32"), ("b", "int32"), ("c", "bfloat16")):
        arr = ts.open({"driver": "zarr", "kvstore": {**base,
                                                     "path": f"{name}/"},
                       "metadata": {"shape": [5, 7], "chunks": [2, 3],
                                    "dtype": "<i4" if dtype == "int32" else
                                    ("bfloat16" if dtype == "bfloat16"
                                     else "<f4"),
                                    "compressor": {"id": "zstd",
                                                   "level": 1}},
                       "create": True}).result()
        data = (rng.standard_normal((5, 7)) * 10).astype(np.float32)
        arr[:4, 1:].write(data[:4, 1:].astype(arr.dtype.numpy_dtype)
                          ).result()
    got = ck.read_orbax(str(tmp_path))
    for name in ("a", "b", "c"):
        want = ts.open({"driver": "zarr", "kvstore": {
            **base, "path": f"{name}/"}}).result().read().result()
        want = np.asarray(want)
        if name == "c":
            want = want.astype(np.float32)
        assert got[name].dtype == want.dtype
        assert got[name].tobytes() == want.tobytes()
        assert not got[name][4].any() and not got[name][:, 0].any()


def test_crc32c_and_corruption(tmp_path):
    assert ck.crc32c(b"123456789") == 0xE3069283
    src = os.path.join(BENCH, "manifest.ocdbt")
    bad = tmp_path / "manifest.ocdbt"
    data = bytearray(open(src, "rb").read())
    data[20] ^= 1
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        ck.read_ocdbt(str(tmp_path))


class _State:
    """The fields CheckpointManager reads of a training state."""

    def __init__(self, seed):
        g = torch.Generator().manual_seed(seed)
        self.model = torch.nn.Linear(3, 2)
        with torch.no_grad():
            self.model.weight.copy_(torch.randn(2, 3, generator=g))
        self.main_opt = torch.optim.Adam(self.model.parameters(), lr=0.1)
        self.aux_opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(2))])
        self.step = seed
        self.generator = torch.Generator().manual_seed(seed)


def test_checkpoint_manager_tags_best_and_gc(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), max_to_keep=2)
    st = _State(1)
    st.model(torch.ones(1, 3)).sum().backward()
    st.main_opt.step()
    st.generator.manual_seed(99)
    for tag, loss in ((1, 3.0), (2, 1.0), (10, 2.0)):
        mgr.save(str(tag), st, loss=loss)
    assert mgr.latest_tag() == "10"
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_10.pt", "checkpoint_2.pt", "checkpoint_best_loss.pt"]
    fresh = _State(5)
    mgr.restore("best_loss", fresh)
    assert torch.equal(fresh.model.weight, st.model.weight)
    assert fresh.step == 1 and fresh.main_opt.state_dict()["state"]
    assert torch.equal(fresh.generator.get_state(), st.generator.get_state())
    assert load_checkpoint(mgr.path("10")).keys() == st.model.state_dict(
    ).keys()


def test_load_matching_filters_by_shape_and_casts():
    live = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    pre = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": torch.ones(5),
           "d": torch.ones(1)}
    out, taken = ck.load_matching(live, pre)
    assert taken == ["a"] and out["a"].dtype == torch.float32
    assert torch.equal(out["a"], torch.ones(2, 3))
    assert out["b"] is live["b"] and out["c"] is live["c"]


def test_load_checkpoint_state_dict_file(tmp_path):
    model = get_model("MLICPP_TINY")
    sd = init_params(model, torch.Generator().manual_seed(0))
    torch.save(sd, tmp_path / "w.pt")
    got = load_checkpoint(str(tmp_path / "w.pt"))
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    back = from_flax(to_flax(sd))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
