"""The port's host data pipeline (master_thesis_tpu_torch/data, runtime,
ops/movements.py, ops/interp.py:resize_hw_np) against the JAX package's on
the fixture tree: equal metas, bit-equal batches, and the decode paths of
a host without the native codec or OpenCV."""

import os
import random
import sys

import numpy as np
import pytest

from master_thesis_tpu.config import Config as JaxConfig
from master_thesis_tpu.data import meta as jax_meta
from master_thesis_tpu.data import pipeline as jax_pipeline
from master_thesis_tpu.runtime import native as jax_native
from master_thesis_tpu.train import build as jax_build
from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.config import Config
from master_thesis_tpu_torch.data import decode, meta, pipeline
from master_thesis_tpu_torch.ops import interp, movements
from master_thesis_tpu_torch.runtime import native, png
from master_thesis_tpu_torch.train.build import build_loaders
from tests.fixtures import make_fake_data_root

ARRAY_KEYS = ("x", "m", "y", "flow_gt", "m_movement", "flows_use")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return make_fake_data_root(str(tmp_path_factory.mktemp("data")))


def _configs(data_root, tmp, **overrides):
    """The same settings as a JAX and a port Config. train_size 56 makes
    the simulator's minimum height 112, above the fixture's 96 rows, so the
    keep-ratio upscale path runs."""
    kw = dict(data_path=data_root, train_size=(56, 56), test_size=(40, 56), frames_n=3,
              batch_size=2, train_max_iterations=2, validation_max_iterations=1,
              min_mask_size=0.0, max_mask_size=1.0, num_workers=0, seed=3)
    kw.update(overrides)
    return (JaxConfig(data_ckpt_path=str(tmp / "jax.ckpt"), **kw),
            Config(data_ckpt_path=str(tmp / "port.ckpt"), device="cpu", **kw))


def _assert_batches_equal(got, want):
    for k in ARRAY_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["names"] == want["names"] and got["indexes"] == want["indexes"]


def test_metas_equal_jax_and_data_ckpt_round_trips(data_root, tmp_path):
    jcfg, cfg = _configs(data_root, tmp_path, min_mask_size=0.01, max_mask_size=0.5)
    want = jax_meta.prepare_data(jcfg)
    got = meta.prepare_data(cfg)
    assert got == want
    # Each package reads the other's data.ckpt, and a second call reads its own.
    assert jax_meta.load_data_checkpoint(cfg.data_ckpt_path) == want
    assert meta.load_data_checkpoint(jcfg.data_ckpt_path) == got
    assert meta.prepare_data(cfg) == got
    # The mask-size filter drops what JAX's drops.
    a = jax_meta.get_meta_youtube_vos(data_root, "train")
    b = meta.get_meta_youtube_vos(data_root, "train")
    jax_meta.clean_masks_meta(a, data_root, 0.99, 1.0, rng=random.Random(0))
    meta.clean_masks_meta(b, data_root, 0.99, 1.0, rng=random.Random(0))
    assert a == b == {}


CASES = {
    "train_sim_bgs_1": ("train", dict(p_simulator_bgs=1.0, p_simulator_masks=1.0)),
    "train_sim_bgs_0": ("train", dict(p_simulator_bgs=0.0)),
    "train_exact_simulator": ("train", dict(p_simulator_bgs=1.0, fast_simulator=False)),
    "train_full_decode": ("train", dict(p_simulator_bgs=0.0, fast_decode=False, frames_n=2)),
    "validation": ("validation", {}),
    "test_whole_clips": ("test", dict(frames_n=-1, batch_size=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_bit_equal_jax(data_root, tmp_path, case):
    split, overrides = CASES[case]
    jcfg, cfg = _configs(data_root, tmp_path, **overrides)
    metas = meta.prepare_data(cfg)
    want = jax_build.build_loaders(jcfg, metas, splits=(split,))[split]
    got = build_loaders(cfg, metas, splits=(split,))[split]
    assert len(got) == len(want) > 0
    epochs = 2 if split == "train" else 1
    for _ in range(epochs):
        # Each loader runs its epoch to the end, which advances its epoch.
        got_epoch, want_epoch = list(got), list(want)
        assert len(got_epoch) == len(want_epoch) == len(want)
        for g, w in zip(got_epoch, want_epoch):
            _assert_batches_equal(g, w)


def test_thread_and_process_workers_equal(data_root, tmp_path):
    _, cfg = _configs(data_root, tmp_path, p_simulator_bgs=0.5, train_max_iterations=3)
    metas = meta.prepare_data(cfg)
    ds = build_loaders(cfg, metas, splits=("train",))["train"].dataset
    inline = list(pipeline.Loader(ds, cfg.batch_size, seed=5, num_workers=1))
    threads = list(pipeline.Loader(ds, cfg.batch_size, seed=5, num_workers=3))
    procs = pipeline.Loader(ds, cfg.batch_size, seed=5, num_workers=2, use_processes=True)
    try:
        got = list(procs)
    finally:
        procs.close()
    assert len(inline) == len(threads) == len(got) == 3
    for a, b, c in zip(inline, threads, got):
        _assert_batches_equal(b, a)
        _assert_batches_equal(c, a)


def test_loader_threads_draw_from_their_own_items(data_root, tmp_path):
    """Threads running the simulator on every item give one thread's
    batches. The JAX package's loader shares one simulator between its
    threads and sets its rng per item, so a thread can draw from another
    item's stream (15 of 90 such batches differed there)."""
    _, cfg = _configs(data_root, tmp_path, train_size=(32, 32), batch_size=4, train_max_iterations=30,
                      p_simulator_bgs=1.0, p_simulator_masks=1.0)
    ds = build_loaders(cfg, meta.prepare_data(cfg), splits=("train",))["train"].dataset
    want = list(pipeline.Loader(ds, 4, seed=1, num_workers=1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often
    try:
        got = list(pipeline.Loader(ds, 4, seed=1, num_workers=8))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def _png_files(tmp_path):
    """Gray (as cv2 writes masks), RGB and palette PNGs, their colours near
    black, where OpenCV's gray rounding matters, and far from it."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(0)
    files = {}
    gray = np.zeros((30, 41), np.uint8)
    cv2.circle(gray, (20, 15), 9, 255, -1)
    gray[0, :5] = (1, 2, 3, 0, 7)
    files["gray"] = str(tmp_path / "gray.png")
    cv2.imwrite(files["gray"], gray)
    near = rng.randint(0, 6, (20, 33, 3)).astype(np.uint8)
    files["rgb_near_black"] = str(tmp_path / "rgb.png")
    cv2.imwrite(files["rgb_near_black"], near)
    pal = Image.fromarray(rng.randint(0, 16, (24, 35)).astype(np.uint8), "P")
    colours = np.concatenate([rng.randint(0, 4, (8, 3)), rng.randint(0, 256, (8, 3))])
    pal.putpalette(colours.astype(np.uint8).reshape(-1).tolist())
    files["palette_near_black"] = str(tmp_path / "pal.png")
    pal.save(files["palette_near_black"])
    # DAVIS-style masks: palette index 0 black, the objects' colours bright.
    davis = Image.fromarray(rng.randint(0, 3, (24, 35)).astype(np.uint8), "P")
    davis.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0])
    files["palette_davis"] = str(tmp_path / "davis.png")
    davis.save(files["palette_davis"])
    return files


def test_zlib_png_reader_equals_cv2_and_jax(tmp_path):
    import cv2

    files = _png_files(tmp_path)
    for name, path in files.items():
        np.testing.assert_array_equal(png.read_png_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                      err_msg=name)
        np.testing.assert_array_equal(png.read_png_rgb(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1],
                                      err_msg=name)
    # The native decoders mark any nonzero channel, OpenCV rounds the gray:
    # they agree where no colour rounds to gray 0.
    for name in ("gray", "palette_davis"):
        want = jax_native.decode_mask_png(files[name])
        np.testing.assert_array_equal((png.read_png_gray(files[name]) > 0)[..., None].astype(np.float32),
                                      want, err_msg=name)
        np.testing.assert_array_equal(native.decode_mask_png(files[name]), want, err_msg=name)
    # write_png's files read back through cv2 and the reader.
    img = np.random.RandomState(1).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    path = str(tmp_path / "written.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], img)
    np.testing.assert_array_equal(png.read_png_rgb(path), img)


@pytest.mark.parametrize("filter_size,iterations", [((3, 3), 4), ((5, 3), 2), ((4, 4), 1), ((2, 3), 3)])
def test_scipy_dilation_equals_cv2(filter_size, iterations):
    rng = np.random.RandomState(2)
    m = (rng.rand(3, 40, 50, 1) > 0.97).astype(np.float32)
    m[0, 0, :3] = 1  # at the border
    np.testing.assert_array_equal(decode.dilate_np(m, filter_size, iterations),
                                  jax_pipeline.dilate_np(m, filter_size, iterations))


def test_no_codec_and_no_opencv(data_root, tmp_path, monkeypatch):
    """Without both, a JPEG raises ImportError naming both ways to decode
    it; PNG masks and PNG backgrounds still read as OpenCV reads them."""
    import cv2

    jpg = os.path.join(data_root, "GOT10k", "train", "seq_a", "00000000.jpg")
    mask = os.path.join(data_root, "YouTubeVOS", "train", "Annotations", "vid1", "00000.png")
    bg_png = str(tmp_path / "bg.jpg")  # PNG content under a background's name
    img = np.random.RandomState(3).randint(0, 256, (12, 17, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "bg.png"), img)
    os.replace(str(tmp_path / "bg.png"), bg_png)
    want_mask = (cv2.imread(mask, cv2.IMREAD_GRAYSCALE) > 0).astype(np.float32)[..., None]
    want_bg = cv2.imread(bg_png, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255.0

    monkeypatch.setitem(native._libs, "codec", None)
    monkeypatch.setitem(native._errors, "codec", "no jpeglib.h")
    monkeypatch.setattr(decode, "_CV2", None)
    with pytest.raises(ImportError, match="native codec or OpenCV"):
        decode.decode_background(jpg)
    np.testing.assert_array_equal(decode.decode_mask(mask), want_mask)
    np.testing.assert_array_equal(decode.decode_background(bg_png), want_bg)


def test_failed_native_build_is_attempted_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho x >> {calls}\necho 'jpeglib.h: No such file' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(native._libs, "codec", raising=False)
    assert native.is_available()["codec"] is False
    assert native.is_available()["codec"] is False
    assert "jpeglib.h" in native.error("codec")
    assert calls.read_text().count("x") == 1
    # Another process (its cache empty) reads the failed compile and does
    # not compile again.
    native._libs.pop("codec")
    assert native.is_available()["codec"] is False
    assert calls.read_text().count("x") == 1
    native._libs.pop("codec")


@pytest.mark.parametrize("shape,size,ac", [((3, 50, 61, 1), (97, 33), False),
                                           ((40, 30, 2), (17, 19), True)])
def test_native_resize_equals_numpy(shape, size, ac):
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    got = interp.resize_hw_np(x, size, mode="bilinear", align_corners=ac)
    ref = x
    for axis, out_size in ((x.ndim - 3, size[0]), (x.ndim - 2, size[1])):
        idx0, idx1, w1 = interp._linear_taps(ref.shape[axis], out_size, ac)
        sh = [1] * ref.ndim
        sh[axis] = out_size
        w1 = w1.reshape(sh)
        ref = np.take(ref, idx0, axis=axis) * (1 - w1) + np.take(ref, idx1, axis=axis) * w1
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c,orig", [(1, (None, None)), (3, (200, 120))])
def test_native_affine_warp_equals_numpy(c, orig):
    rng = np.random.RandomState(4)
    h, w, oh, ow, n = 96, 128, 40, 56, 3
    x = rng.rand(h, w, c).astype(np.float32)
    theta = np.stack([np.asarray([[1.0, 0.02, 0.1], [-0.03, 0.98, -0.2]])
                      + rng.uniform(-0.1, 0.1, (2, 3)) for _ in range(n)])
    rw, rh = orig
    ws, hs = int(w * 1.5), int(h * 1.5)
    gx1 = 2.0 * np.clip((np.arange(ow) + 0.5) * (ws / ow) - 0.5, 0.0, ws - 1) / (ws - 1) - 1.0
    gy1 = 2.0 * np.clip((np.arange(oh) + 0.5) * (hs / oh) - 0.5, 0.0, hs - 1) / (hs - 1) - 1.0
    got = native.affine_warp(x, theta, gx1, gy1, (ws, -1.0 if rw is None else rw, w),
                             (hs, -1.0 if rh is None else rh, h))

    def to_orig(pn, vsize, rsize, osize):
        if rsize is None:
            return pn
        pv = (pn + 1.0) * 0.5 * (vsize - 1)
        return 2.0 * ((pv + 0.5) * (osize / rsize) - 0.5) / (osize - 1) - 1.0

    gy_v, gx_v = np.meshgrid(gy1, gx1, indexing="ij")
    t = theta[:, None, None]
    ox = t[..., 0, 0] * gx_v + t[..., 0, 1] * gy_v + t[..., 0, 2]
    oy = t[..., 1, 0] * gx_v + t[..., 1, 1] * gy_v + t[..., 1, 2]
    flow = np.stack([to_orig(ox, ws, rw, w), to_orig(oy, hs, rh, h)], -1).astype(np.float32)
    # The f64 grid takes the numpy path; the f32 grid the native one.
    want = movements.grid_sample_bilinear_np(np.repeat(x[None], n, 0), flow.astype(np.float64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.grid_sample_bilinear(np.repeat(x[None], n, 0), flow, True), want)


@pytest.mark.parametrize("n,h,w,c,oh,ow,ac", [(3, 64, 48, 1, 32, 40, False), (2, 17, 23, 4, 19, 11, True)])
def test_native_grid_sample_equals_numpy(n, h, w, c, oh, ow, ac):
    rng = np.random.RandomState(1)
    x = rng.rand(n, h, w, c).astype(np.float32)
    g = (rng.rand(n, oh, ow, 2) * 2.6 - 1.3).astype(np.float32)
    np.testing.assert_array_equal(native.grid_sample_bilinear(x, g, ac),
                                  movements.grid_sample_bilinear_np(x, g.astype(np.float64), ac))
