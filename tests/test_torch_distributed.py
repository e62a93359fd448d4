"""Data parallelism of the port over ``torch.distributed``: two real
processes joined over gloo on the CPU (as ``tests/test_multiprocess.py``
launches two JAX processes), each under its own time limit so that a hung
rendezvous fails instead of hanging the run.

Checked, on MLICPP_TINY at 64x64:

* ``process_allgather``, ``local_batch_slice`` and ``tools.statistics.
  gather_rows`` (the shapes of the JAX test);
* a data-parallel ``train_step`` (global batch 4, two slices of 2)
  against one process's step on the global batch: the loss within rtol
  1e-5 and every parameter within rtol 2e-4, atol 2e-6 (JAX's bounds for
  its sharded step, ``tests/test_parallel.py:44-47``), both processes'
  parameters bit-equal to each other;
* a data-parallel ``vbr_train_step`` (MLICPP_TINY_VBR): ``alpha`` bit-equal
  on both processes and within 1e-4 of one process's;
* ``tools.train`` under the process group (3 steps, global batch 4): its
  checkpoint against the single-process CLI's at the same bounds (SGD
  with momentum: its update is linear in the gradient, where Adam's
  first updates of an element near zero follow the gradient's last bits,
  as ``test_torch_vbr.py`` notes);
* ``tools.statistics`` over 3 images: the CSV's rows equal the
  single-process tool's.
"""

import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mlic_tpu_torch.data.folder import synthetic_batches
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.parallel import mesh
from mlic_tpu_torch.tools import statistics as tstats
from mlic_tpu_torch.tools import train as ttrain
from mlic_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    train_step,
)
from mlic_tpu_torch.train.vbr import vbr_train_step
from mlic_tpu_torch.weights import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 4
WORKER_TIMEOUT_S = 240

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
out_dir, image_dir = sys.argv[1], sys.argv[2]
from mlic_tpu_torch.data.folder import synthetic_batches
from mlic_tpu_torch.models.registry import get_model
from mlic_tpu_torch.parallel import mesh
from mlic_tpu_torch.tools import statistics, train
from mlic_tpu_torch.tools.statistics import gather_rows
from mlic_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                          train_step)
from mlic_tpu_torch.train.vbr import vbr_train_step
from mlic_tpu_torch.weights import init_params

assert mesh.init_from_env("cpu") and mesh.process_count() == 2
pid = mesh.process_index()
res = {"backend": torch.distributed.get_backend()}
res["gathered"] = np.asarray(mesh.process_allgather(
    np.full((2,), pid, np.float32))).tolist()
sl = mesh.local_batch_slice(8)
res["slice"] = [sl.start, sl.stop]
files = [f"img{i}.png" for i in range(5)]  # odd count: shards of 3 and 2
rows = [{"bpp": float(pid * 10 + i), "psnr": 30.0 + pid, "ms_ssim": 0.9}
        for i in range(len(files[pid::2]))]
res["rows"] = gather_rows(rows, files, pid, 2, mesh.process_allgather)

def seeded(name):
    m = get_model(name)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    return m

cfg = TrainConfig(lmbda=0.013, learning_rate=1e-4, seed=0)
batch = next(synthetic_batches(GLOBAL_BATCH, 64, 1, seed=3))
local = batch[mesh.local_batch_slice(GLOBAL_BATCH)]
st = create_train_state(seeded("MLICPP_TINY"), cfg, "cpu")
m = train_step(st, local, cfg)
res["loss"] = float(m["loss"])
res["grad_norm"] = float(m["grad_norm"])
torch.save(st.model.state_dict(), os.path.join(out_dir, f"dp_{pid}.pt"))

vst = create_train_state(seeded("MLICPP_TINY_VBR"), cfg, "cpu")
vm = vbr_train_step(vst, batch[:2][mesh.local_batch_slice(2)], cfg, "loss")
res["alpha"] = vm["alpha"].tolist()
res["vbr_loss_per_level"] = vm["loss_per_level"].tolist()

res["cli"] = train.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic",
                         "--steps", "3", "--optimizer", "sgd",
                         "--batch-size", str(GLOBAL_BATCH),
                         "--patch-size", "64", "--log-freq", "1",
                         "--ckpt-dir", os.path.join(out_dir, "cli")])
res["stats"] = statistics.main(["--cpu", "--model", "MLICPP_TINY",
                                "--dataset", image_dir, "--out",
                                os.path.join(out_dir, "stats.csv")])
with open(os.path.join(out_dir, f"rank{pid}.json"), "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
""".replace("GLOBAL_BATCH", str(GLOBAL_BATCH))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU operators on one thread while this module runs (see
    ``test_torch_train.py``: six xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _seeded(name):
    m = get_model(name)
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(0)))
    return m


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("stats_images")
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate(((64, 64), (64, 128), (50, 70))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"im{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, images):
    """Both processes' results; each process is killed at its time limit,
    and a failed or timed-out rank fails the test with its output."""
    out = tmp_path_factory.mktemp("ranks")
    worker = out / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(out), images], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=str(out)))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish in {WORKER_TIMEOUT_S} s "
                    "(hung rendezvous or collective)")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode(errors="replace")[-3000:]
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    return out, res


@pytest.fixture(scope="module")
def one_process():
    """One process's train and MGDA steps on the global batch."""
    cfg = TrainConfig(lmbda=0.013, learning_rate=1e-4, seed=0)
    batch = next(synthetic_batches(GLOBAL_BATCH, 64, 1, seed=3))
    st = create_train_state(_seeded("MLICPP_TINY"), cfg, "cpu")
    m = train_step(st, batch, cfg)
    vst = create_train_state(_seeded("MLICPP_TINY_VBR"), cfg, "cpu")
    vm = vbr_train_step(vst, batch[:2], cfg, "loss")
    return {"loss": float(m["loss"]), "params": st.model.state_dict(),
            "alpha": vm["alpha"].numpy(),
            "vbr_loss_per_level": vm["loss_per_level"].numpy()}


def _params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=k)


def test_helpers_on_one_process(monkeypatch):
    """Without a process group: index 0 of 1, the whole batch, the local
    values back, no reduction; no group is joined without ``WORLD_SIZE``,
    and a CUDA group without CUDA raises instead of taking gloo."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_from_env("cpu") is False
    assert not mesh.is_distributed()
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    assert mesh.local_batch_slice(6) == slice(0, 6)
    x = np.arange(3.0)
    assert mesh.process_allgather(x) is x
    t = torch.ones(3)
    mesh.all_reduce_mean_([t])
    assert torch.equal(t, torch.ones(3))
    assert _slice_over_two(6) == slice(0, 3)
    with pytest.raises(ValueError, match="divide"):
        _slice_over_two(5)
    if not torch.cuda.is_available():
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.init_from_env(None)
        assert not mesh.is_distributed()


def _slice_over_two(n):
    """``local_batch_slice`` as process 0 of 2 would take it."""
    from unittest import mock
    with mock.patch.object(mesh, "process_count", lambda: 2):
        return mesh.local_batch_slice(n)


def test_allgather_slice_and_gather_rows(two_ranks):
    _, res = two_ranks
    for rank, r in enumerate(res):
        assert r["backend"] == "gloo"
        assert r["gathered"] == [[0.0, 0.0], [1.0, 1.0]]
        assert r["slice"] == [4 * rank, 4 * rank + 4]
        names = [row["name"] for row in r["rows"]]
        assert names == ["img0.png", "img2.png", "img4.png", "img1.png",
                         "img3.png"]
        assert [row["bpp"] for row in r["rows"]] == [0.0, 1.0, 2.0, 10.0,
                                                     11.0]


def test_data_parallel_step_equals_one_process(two_ranks, one_process):
    out, res = two_ranks
    for r in res:
        np.testing.assert_allclose(r["loss"], one_process["loss"],
                                   rtol=1e-5)
    assert res[0]["loss"] == res[1]["loss"]
    assert res[0]["grad_norm"] == res[1]["grad_norm"]
    p0 = torch.load(out / "dp_0.pt", weights_only=True)
    p1 = torch.load(out / "dp_1.pt", weights_only=True)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    _params_close(p0, one_process["params"])


def test_data_parallel_mgda_alpha(two_ranks, one_process):
    _, res = two_ranks
    assert res[0]["alpha"] == res[1]["alpha"]
    np.testing.assert_allclose(res[0]["alpha"], one_process["alpha"],
                               atol=1e-4)
    np.testing.assert_allclose(res[0]["vbr_loss_per_level"],
                               one_process["vbr_loss_per_level"], rtol=1e-5)
    assert abs(sum(res[0]["alpha"]) - 1.0) < 1e-5


def test_train_cli_under_the_process_group(two_ranks, tmp_path):
    out, res = two_ranks
    single = ttrain.main(["--cpu", "--model", "MLICPP_TINY", "--synthetic",
                          "--steps", "3", "--optimizer", "sgd",
                          "--batch-size", str(GLOBAL_BATCH),
                          "--patch-size", "64", "--log-freq", "1",
                          "--ckpt-dir", str(tmp_path)])
    for r in res:
        assert r["cli"]["step"] == 3
        np.testing.assert_allclose(r["cli"]["loss"], single["loss"],
                                   rtol=1e-5)
    ckpt = "mlic_tpu_torch/checkpoint_3.pt"
    assert (out / "cli" / ckpt).is_file()             # written by rank 0
    got = torch.load(out / "cli" / ckpt, weights_only=True)["model"]
    want = torch.load(tmp_path / ckpt, weights_only=True)["model"]
    _params_close(got, want)


def test_statistics_cli_gathers_every_row(two_ranks, images, tmp_path):
    out, res = two_ranks
    single = tstats.main(["--cpu", "--model", "MLICPP_TINY", "--dataset",
                          images, "--out", str(tmp_path / "one.csv")])
    with open(out / "stats.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["name"] for r in rows] == ["im0.png", "im2.png", "im1.png"]
    by_name = {r["name"]: r for r in single}
    for r in rows:
        for k in ("bpp", "psnr"):
            np.testing.assert_allclose(float(r[k]), by_name[r["name"]][k],
                                       rtol=1e-5)
        assert np.isnan(float(r["ms_ssim"]))
    assert len(res[1]["stats"]) == 1 and len(res[0]["stats"]) == 3
