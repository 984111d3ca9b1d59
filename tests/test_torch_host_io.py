"""The PyTorch port's host-side I/O modules (``utils/bbox``, ``geometry/gps``,
``utils/video``, ``utils/native``) against the JAX package's on the same inputs.

These modules are numpy and standard library on both sides, so integers and pixels
are exact and float64 values agree to 1e-9 relative.
"""
import numpy as np
import pytest
import yaml

from future_urban_scene_generation_tpu.geometry import gps as jgps
from future_urban_scene_generation_tpu.utils import bbox as jbbox
from future_urban_scene_generation_tpu.utils import native as jnative
from future_urban_scene_generation_tpu.utils import video as jvideo
from future_urban_scene_generation_tpu_torch.geometry import gps
from future_urban_scene_generation_tpu_torch.utils import bbox, native, video


def test_bounding_box_truncation_order():
    rng = np.random.RandomState(0)
    for _ in range(200):
        x, y = rng.rand(2) * 300 - 20
        w, h = rng.rand(2) * 200 + 1
        scale = rng.choice([None, 0.8, 1.0, 1.3, 1.77])
        bounds = rng.choice([None, 1]) and (0, 319, 0, 239)
        a = bbox.BoundingBox(x, y, w, h, scale=scale, bounds=bounds)
        b = jbbox.BoundingBox(x, y, w, h, scale=scale, bounds=bounds)
        assert a.xyxy == b.xyxy and a.xywh == b.xywh and a.mid_bottom == b.mid_bottom
        assert all(isinstance(v, int) for v in a.xyxy)
    with pytest.raises(ValueError):
        bbox.BoundingBox(0, 0, 4, 4, scale=0.0)


def test_bbox_array_helpers():
    rng = np.random.RandomState(1)
    b = rng.rand(7, 4) * 100
    np.testing.assert_array_equal(bbox.xywh_to_xyxy(b), jbbox.xywh_to_xyxy(b))
    np.testing.assert_array_equal(bbox.xyxy_to_xywh(b), jbbox.xyxy_to_xywh(b))
    xyxy = bbox.xywh_to_xyxy(b)
    np.testing.assert_array_equal(bbox.scale_about_center(xyxy, 1.3),
                                  jbbox.scale_about_center(xyxy, 1.3))
    np.testing.assert_array_equal(bbox.clip_to_bounds(xyxy, (5, 90, 5, 80)),
                                  jbbox.clip_to_bounds(xyxy, (5, 90, 5, 80)))
    np.testing.assert_array_equal(bbox.mid_bottom(xyxy), jbbox.mid_bottom(xyxy))


def test_gps_matches_jax_package_float64():
    rng = np.random.RandomState(2)
    hmat = np.array([[1e-5, 2e-7, 45.0], [-3e-7, 1e-5, 11.0], [1e-9, 2e-9, 1.0]])
    inv = np.linalg.inv(hmat)
    pts = np.stack([100 + 15.0 * np.arange(6) + rng.rand(6), 200 + 4.0 * np.arange(6)], -1)
    got = gps.trajectory_to_meters(pts, inv)
    ref = jgps.trajectory_to_meters(pts, inv)
    assert got.dtype == np.float64 and got.shape == (6, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    g = gps.pixels_to_gps(pts, inv)
    np.testing.assert_allclose(g, jgps.pixels_to_gps(pts, inv), rtol=1e-12)
    np.testing.assert_allclose(gps.geodesic_distance(g[0], g[-1]),
                               jgps.geodesic_distance(g[0], g[-1]), rtol=1e-9)
    # A static track (zero extent) stays finite.
    assert np.isfinite(gps.trajectory_to_meters(np.repeat(pts[:1], 3, 0), inv)).all()


def _matrix_str(hmat):
    return ";".join(" ".join(repr(float(v)) for v in row) for row in hmat)


@pytest.mark.parametrize("style", ["plain", "double", "single", "folded", "extra_keys"])
def test_calibration_parser_matches_yaml(tmp_path, style):
    """The hand-written parser reads what ``yaml.safe_dump`` writes: plain, quoted,
    and long values folded over continuation lines."""
    rng = np.random.RandomState(3)
    hmat = np.array([[1e-5, 0, 45.0], [0, 1e-5, 11.0], [0, 0, 1.0]])
    if style in ("folded", "extra_keys"):
        hmat = rng.randn(3, 3) * [1e-5, 1e-5, 40.0]  # 17-digit reprs: > 80 columns
    data = {"Homography matrix": _matrix_str(hmat)}
    kwargs = {}
    if style == "double":
        kwargs = {"default_style": '"'}
    elif style == "single":
        kwargs = {"default_style": "'"}
    elif style == "extra_keys":
        data = {"Camera": "c001", **data, "Reprojection error": 0.32}
        kwargs = {"sort_keys": False}
    path = tmp_path / "calibration.txt"
    path.write_text(yaml.safe_dump(data, **kwargs))
    if style in ("folded", "extra_keys"):
        assert len(path.read_text().splitlines()) > len(data)  # the value is folded
    ref = jvideo.parse_calibration_file(path)
    got = video.parse_calibration_file(path)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, hmat)
    np.testing.assert_array_equal(video.inverse_homography(got, True),
                                  jvideo.inverse_homography(ref, True))


def test_calibration_parser_rejects_malformed(tmp_path):
    path = tmp_path / "calibration.txt"
    path.write_text("Something else: 1 2 3\n")
    with pytest.raises(ValueError):
        video.parse_calibration_file(path)
    path.write_text("Homography matrix: 1 2 3;4 5 6\n")
    with pytest.raises(ValueError):
        video.parse_calibration_file(path)
    path.write_text("Homography matrix: 1 2 x;4 5 6;7 8 9\n")
    with pytest.raises(ValueError):
        video.parse_calibration_file(path)


def test_tracking_parser_and_future_track(tmp_path):
    (tmp_path / "mtsc").mkdir()
    rng = np.random.RandomState(4)
    rows = []
    for f in range(1, 15):
        for vid in (3, 7):
            rows.append([f, vid, *(rng.rand(4) * 200), 1, -1, -1, -1])
    np.savetxt(tmp_path / "mtsc" / "mtsc_tc_ssd512.txt", np.asarray(rows), delimiter=",")
    got = video.parse_tracking_file(tmp_path, "tc", "ssd512")
    ref = jvideo.parse_tracking_file(tmp_path, "tc", "ssd512")
    assert got.shape == (28, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    for vid, frame_id in ((7, 3), (3, 10), (7, 14), (9, 1)):
        np.testing.assert_array_equal(video.select_future_track(got, vid, frame_id),
                                      jvideo.select_future_track(ref, vid, frame_id))
    assert len(video.select_future_track(got, 7, 10)) == 3  # frames 10, 12, 14
    # One row parses as (1, 6).
    np.savetxt(tmp_path / "mtsc" / "mtsc_tc_yolo3.txt", np.asarray(rows[:1]), delimiter=",")
    assert video.parse_tracking_file(tmp_path, "tc", "yolo3").shape == (1, 6)


def test_input_validation_errors(tmp_path):
    """As tests/test_service_cli.py:122-144."""
    with pytest.raises(FileNotFoundError):
        video.parse_tracking_file(tmp_path, "tc", "ssd512")
    with pytest.raises(FileNotFoundError):
        video.parse_calibration_file(tmp_path / "calibration.txt")
    (tmp_path / "frames").mkdir()
    with pytest.raises(FileNotFoundError):
        video.VideoReader(tmp_path / "frames", resize_hw=None)
    (tmp_path / "mtsc").mkdir()
    np.savetxt(tmp_path / "mtsc" / "mtsc_tc_ssd512.txt", np.zeros((3, 7)), delimiter=",")
    with pytest.raises(ValueError):
        video.parse_tracking_file(tmp_path, "tc", "ssd512")


@pytest.mark.parametrize("out_hw", [(45, 80), (120, 200), (36, 64)])
def test_resize_bilinear_np_matches_jax_package(out_hw):
    rng = np.random.RandomState(5)
    img = rng.rand(72, 128, 3).astype(np.float32)
    np.testing.assert_array_equal(video.resize_bilinear_np(img, out_hw),
                                  jvideo.resize_bilinear_np(img, out_hw))
    assert video.resize_bilinear_np(img, (72, 128)) is img


@pytest.mark.parametrize("kind", ["npy", "png"])
def test_video_reader_frame_directories(tmp_path, kind):
    rng = np.random.RandomState(6)
    frames_u8 = rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames_u8):
        if kind == "npy":
            np.save(d / f"{i:04}.npy", f.astype(np.float32) / 255.0)
        else:
            native.write_png(d / f"{i:04}.png", f)
    ours = video.VideoReader(d, resize_hw=None)
    theirs = jvideo.VideoReader(d, resize_hw=None)
    for fid in (1, 2, 3):
        got = ours.read(fid)
        assert got.dtype == np.float32 and got.shape == (48, 64, 3)
        np.testing.assert_array_equal(got, frames_u8[fid - 1].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got, theirs.read(fid))
    assert ours.read(0) is None and ours.read(4) is None
    # A working resolution other than the files': the numpy bilinear resize
    # (cv2's convention: within 1e-6 of whatever the JAX reader resizes with).
    small = video.VideoReader(d, resize_hw=(24, 32)).read(2)
    assert small.shape == (24, 32, 3)
    np.testing.assert_allclose(small, jvideo.VideoReader(d, resize_hw=(24, 32)).read(2),
                               atol=1e-6)
    ours.close()


@pytest.mark.parametrize("shape", [(37, 53, 3), (16, 24, 4), (20, 31)])
def test_png_round_trip_byte_exact(tmp_path, shape):
    """Our writer -> the JAX package's decoder and cv2; cv2's and PIL's writers
    (adaptive scanline filters) -> our reader. Pixels are exact every way."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    # A smooth image makes the other encoders pick Sub / Up / Average / Paeth rows.
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = ((yy * 3 + xx * 2) % 256).astype(np.uint8)
    smooth = smooth if len(shape) == 2 else np.stack(
        [np.roll(smooth, c * 5, 1) for c in range(shape[2])], -1)
    for k, pix in enumerate((img, smooth)):
        rgb = np.repeat(pix[..., None], 3, -1) if pix.ndim == 2 else pix[..., :3]
        path = tmp_path / f"ours_{k}.png"
        native.write_png(path, pix)
        np.testing.assert_array_equal(native.read_png(path), rgb)
        theirs = jnative.read_png(path)
        if theirs is not None:  # None: the JAX package's native library did not build
            np.testing.assert_array_equal(theirs, rgb)
        back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if pix.ndim == 3:
            back = back[..., [2, 1, 0] + ([3] if pix.shape[2] == 4 else [])]
        np.testing.assert_array_equal(back, pix)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pix)

        cv_path, pil_path = tmp_path / f"cv_{k}.png", tmp_path / f"pil_{k}.png"
        cv2.imwrite(str(cv_path), pix if pix.ndim == 2 else
                    pix[..., [2, 1, 0] + ([3] if pix.shape[2] == 4 else [])])
        Image.fromarray(pix).save(pil_path, optimize=True)
        np.testing.assert_array_equal(native.read_png(cv_path), rgb)
        np.testing.assert_array_equal(native.read_png(pil_path), rgb)
        if pix.ndim == 3 and pix.shape[2] == 3:
            jpath = tmp_path / f"jax_{k}.png"
            jnative.write_png(jpath, pix)
            np.testing.assert_array_equal(native.read_png(jpath), pix)


def _png_with_filter(pix, ftype):
    """A PNG of ``pix`` (H, W, C) whose every scanline uses filter ``ftype``."""
    import struct
    import zlib

    h, w, c = pix.shape
    cur = pix.reshape(h, w * c).astype(np.int32)
    left = np.concatenate([np.zeros((h, c), np.int32), cur[:, :-c]], 1)
    up = np.concatenate([np.zeros((1, w * c), np.int32), cur[:-1]], 0)
    upleft = np.concatenate([np.zeros((h, c), np.int32), up[:, :-c]], 1)
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = [0 * cur, left, up, (left + up) // 2, paeth][ftype]
    rows = np.concatenate([np.full((h, 1), ftype), (cur - pred) % 256], 1).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + native._chunk(b"IHDR", ihdr)
            + native._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + native._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_every_scanline_filter(ftype):
    rng = np.random.RandomState(8 + ftype)
    pix = rng.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.decode_png(_png_with_filter(pix, ftype)), pix)


def test_png_errors_and_async_writer(tmp_path):
    with pytest.raises(IOError):
        native.decode_png(b"not a png at all")
    good = native.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(IOError):
        native.decode_png(good[:40])  # truncated
    with pytest.raises(TypeError):
        native.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        native.encode_png(np.zeros((4, 4, 2), np.uint8))
    rng = np.random.RandomState(9)
    imgs = rng.randint(0, 256, (6, 30, 40, 3)).astype(np.uint8)
    with native.AsyncPngWriter(n_threads=3) as writer:
        for i, im in enumerate(imgs):
            writer.submit(tmp_path / f"{i}.png", im)
        assert writer.flush() == 0
        writer.submit(tmp_path / "missing_dir" / "x.png", imgs[0])
        assert writer.flush() == 1  # a failed write is counted, not raised
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(native.read_png(tmp_path / f"{i}.png"), im)
