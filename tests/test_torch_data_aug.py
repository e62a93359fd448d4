"""The port's training recipe against the JAX package, on the CPU:
AutoAugment (every op at every magnitude bin, and every sub-policy through
``autoaugment``), the augmented ``ImageFolderDataset`` batch, the
``utils.misc`` helpers and the training CLI's patch schedule.  Everything
here is numpy and PIL on both sides, so the comparisons are exact."""

import argparse

import numpy as np
import pytest
from PIL import Image

from mlic_tpu.data import autoaugment as jaug
from mlic_tpu.data import folder as jfolder
from mlic_tpu.utils import misc as jmisc
from mlic_tpu_torch.data import autoaugment as taug
from mlic_tpu_torch.data import folder as tfolder
from mlic_tpu_torch.tools import train as ttrain
from mlic_tpu_torch.utils import misc as tmisc
from tools import train as jtrain


def _image(seed, shape=(48, 40, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_policy_tables_equal():
    assert taug.IMAGENET_POLICY == jaug.IMAGENET_POLICY
    assert taug._SIGNED == jaug._SIGNED and taug._BINS == jaug._BINS


def test_every_op_at_every_bin_bit_equal():
    im = Image.fromarray(_image(1))
    ops = sorted({op for sub in jaug.IMAGENET_POLICY for op, _, _ in sub}
                 | {"ShearY", "TranslateX", "TranslateY", "Brightness"})
    for op in ops:
        for b in range(jaug._BINS):
            mag = jaug._magnitude(op, b, im.size)
            assert taug._magnitude(op, b, im.size) == mag, (op, b)
            for m in (mag, -mag):
                want = np.asarray(jaug._apply_op(im, op, m))
                got = np.asarray(taug._apply_op(im, op, m))
                assert got.tobytes() == want.tobytes(), (op, b, m)
    with pytest.raises(ValueError, match="unknown op"):
        taug._apply_op(im, "Warp", 0.0)


def test_autoaugment_every_subpolicy_bit_equal():
    """``autoaugment`` over seeds that between them draw all 25
    sub-policies (the first draw of each seed picks it)."""
    img = _image(2)
    seen = set()
    for seed in range(120):
        seen.add(int(np.random.default_rng(seed).integers(
            0, len(jaug.IMAGENET_POLICY))))
        want = jaug.autoaugment(img, np.random.default_rng(seed))
        got = taug.autoaugment(img, np.random.default_rng(seed))
        assert got.dtype == np.uint8 and got.shape == img.shape
        assert got.tobytes() == want.tobytes(), seed
    assert seen == set(range(len(jaug.IMAGENET_POLICY)))


def test_augmented_dataset_batch_bit_equal(tmp_path):
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(((80, 80), (72, 96), (64, 70))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(tmp_path / f"im{i}.png")
    for pi, pc in ((0, 1), (1, 2)):
        jd = jfolder.ImageFolderDataset(str(tmp_path), 64, seed=4,
                                        process_index=pi, process_count=pc,
                                        augment="autoaugment")
        td = tfolder.ImageFolderDataset(str(tmp_path), 64, seed=4,
                                        process_index=pi, process_count=pc,
                                        augment="autoaugment")
        assert jd.files == td.files
        for _ in range(3):
            assert td.sample_batch(3).tobytes() == \
                jd.sample_batch(3).tobytes()
    plain = tfolder.ImageFolderDataset(str(tmp_path), 64, seed=4)
    aug = tfolder.ImageFolderDataset(str(tmp_path), 64, seed=4,
                                     augment="autoaugment")
    assert plain.sample_batch(4).tobytes() != aug.sample_batch(4).tobytes()
    with pytest.raises(ValueError, match="augment"):
        tfolder.ImageFolderDataset(str(tmp_path), 64, augment="randaugment")


def test_misc_equal(tmp_path):
    x = np.random.default_rng(5).random((2, 70, 52, 3)).astype(np.float32)
    for patch in (16, 13):
        p = tmisc.image_to_patches(x, patch)
        np.testing.assert_array_equal(p, jmisc.image_to_patches(x, patch))
        grid = (70 // patch, 52 // patch)
        np.testing.assert_array_equal(tmisc.patches_to_image(p, grid),
                                      jmisc.patches_to_image(p, grid))
    cfg = tmisc.Config(lr=1e-4, name="run", steps=[1, 2])
    cfg.batch = 8
    assert cfg.batch == 8 and cfg["lr"] == 1e-4
    with pytest.raises(AttributeError):
        cfg.missing
    cfg.to_json(str(tmp_path / "c.json"))
    assert tmisc.Config.from_json(str(tmp_path / "c.json")) == \
        jmisc.Config.from_json(str(tmp_path / "c.json")) == dict(cfg)
    tm, jm = tmisc.AverageMeter(), jmisc.AverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 5)):
        tm.update(v, n)
        jm.update(v, n)
    assert (tm.val, tm.sum, tm.count, tm.avg) == \
        (jm.val, jm.sum, jm.count, jm.avg)
    d = {"psnr": 31.123456, "bpp": 0.5, "name": "kodim01", "n": 3}
    assert tmisc.pretty_print_dict(d) == jmisc.pretty_print_dict(d)
    assert tmisc.pretty_print_dict(d, 2) == jmisc.pretty_print_dict(d, 2)
    banner = tmisc.get_system_info_str()
    for key in ("platform", "python", "torch", "devices", "processes: 1"):
        assert key in banner, key
    assert "jax" not in banner


@pytest.mark.parametrize("milestones", [[], ["2:128"], ["9:512", "3:128"],
                                        ["0:96"]])
def test_patch_schedule_equal(milestones):
    argv = ["--patch-size", "64", "--patch-milestones", *milestones]
    targs = ttrain.parse_args(argv)
    jargs = jtrain.parse_args(argv)
    assert isinstance(targs, argparse.Namespace)
    sched = ttrain._patch_schedule(targs)
    assert sched == jtrain._patch_schedule(jargs)
    for step in range(12):
        assert ttrain._patch_at(sched, step) == jtrain._patch_at(sched, step)
