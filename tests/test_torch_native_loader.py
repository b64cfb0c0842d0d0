"""The port's native frame loader (``visual_slam_tpu_torch.io.native``)
against the JAX package's on the same files: the JAX loader tests mirrored
through the port, frames equal element for element, the port's own build
directory, and the numpy PNG writer that the dataset runs share
(``tests/dataset_world.py``)."""
from pathlib import Path

import cv2
import numpy as np
import pytest

import dataset_world
from visual_slam_tpu.io import native as jnative
from visual_slam_tpu_torch.io import native
from visual_slam_tpu_torch.io.native import NativeDatasetSource, decode_image, get_lib

PKG = Path(native.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    return get_lib()


def _write_images(tmp_path, rng, n=6, h=40, w=56):
    paths = []
    for i in range(n):
        img = rng.integers(0, 255, (h, w), dtype=np.uint8)
        p = tmp_path / f"{i:06d}.png"
        cv2.imwrite(str(p), img)
        paths.append((p, img))
    return paths


def test_png_gray_decode_parity(lib, tmp_path, rng):
    for p, img in _write_images(tmp_path, rng):
        np.testing.assert_array_equal(decode_image(p), img)


def test_png_color_decode_parity(lib, tmp_path, rng):
    img = rng.integers(0, 255, (30, 44, 3), dtype=np.uint8)
    p = tmp_path / "c.png"
    cv2.imwrite(str(p), img[:, :, ::-1])  # cv2 writes BGR
    np.testing.assert_array_equal(decode_image(p), img)


def test_pgm_ppm_bmp(lib, tmp_path, rng):
    g = rng.integers(0, 255, (25, 33), dtype=np.uint8)
    c = rng.integers(0, 255, (25, 33, 3), dtype=np.uint8)
    pg, pp, bm = tmp_path / "x.pgm", tmp_path / "x.ppm", tmp_path / "x.bmp"
    cv2.imwrite(str(pg), g)
    cv2.imwrite(str(pp), c[:, :, ::-1])
    cv2.imwrite(str(bm), c[:, :, ::-1])
    np.testing.assert_array_equal(decode_image(pg), g)
    np.testing.assert_array_equal(decode_image(pp), c)
    np.testing.assert_array_equal(decode_image(bm), c)


def test_prefetch_dataset_order_and_values(lib, tmp_path, rng):
    paths = _write_images(tmp_path, rng, n=10)
    ds = NativeDatasetSource(tmp_path, fps=10.0, n_workers=3, prefetch=4)
    assert ds.num_frames() == 10
    assert ds.get_frame_shape() == (40, 56)
    for i, (_, img) in enumerate(paths):
        frame, ts = ds.get_frame()
        assert frame is not None
        assert frame.dtype == np.float32
        np.testing.assert_allclose(frame, img.astype(np.float32), atol=0.5)
        assert ts == pytest.approx(i / 10.0)
    frame, _ = ds.get_frame()
    assert frame is None
    assert ds.decode_errors() == 0
    ds.release()


@pytest.mark.parametrize("grayscale", [True, False])
def test_frames_equal_the_jax_loaders(lib, tmp_path, rng, grayscale):
    """Gray and colour PNGs, one BMP: ``decode_image`` and every frame of
    ``NativeDatasetSource`` (the C++ grayscale conversion of the colour
    files included) equal the JAX package's, element for element, with the
    same timestamps from a timestamps file."""
    imgs = [rng.integers(0, 256, (24, 36), dtype=np.uint8) for _ in range(3)]
    imgs += [rng.integers(0, 256, (24, 36, 3), dtype=np.uint8) for _ in range(2)]
    paths = []
    for i, img in enumerate(imgs):
        p = tmp_path / f"{i:06d}.{'bmp' if i == 4 else 'png'}"
        cv2.imwrite(str(p), img if img.ndim == 2 else img[:, :, ::-1])
        paths.append(p)
    for p in paths:
        a, b = decode_image(p), jnative.decode_image(p)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    stamps = tmp_path / "times.txt"
    stamps.write_text("".join(f"{0.25 + 0.1 * i:.6f}\n" for i in range(len(paths))))
    ours = NativeDatasetSource(tmp_path, grayscale=grayscale, n_workers=2, prefetch=2, timestamps_file=stamps)
    theirs = jnative.NativeDatasetSource(tmp_path, grayscale=grayscale, n_workers=2, prefetch=2,
                                         timestamps_file=stamps)
    assert ours.num_frames() == theirs.num_frames() == len(paths)
    assert ours.get_frame_shape() == theirs.get_frame_shape() == (24, 36)
    while theirs.is_ok():
        (a, ta), (b, tb) = ours.get_frame(), theirs.get_frame()
        assert a.dtype == b.dtype == (np.float32 if grayscale else np.uint8)
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    assert not ours.is_ok()
    assert ours.get_frame()[0] is None
    assert ours.decode_errors() == theirs.decode_errors() == 0
    ours.release()
    theirs.release()


def test_library_is_built_in_the_ports_own_directory(lib):
    """The port builds ``native/loader.cpp`` into its git-ignored
    ``visual_slam_tpu_torch/build/``, not into the JAX package's
    ``native/build/``, and stamps it with the source's hash."""
    built = Path(lib._name).resolve()
    assert built == (PKG / "build" / "libvslam_loader.so").resolve()
    assert native._SRC == PKG.parent / "native" / "loader.cpp"
    assert (PKG / "build" / "libvslam_loader.sha256").read_text() == native._source_hash()
    assert not any(p.name.endswith(".tmp") for p in (PKG / "build").iterdir() if "loader" in p.name)


def test_stale_stamp_rebuilds(lib, monkeypatch, tmp_path):
    """A library whose stamp does not match the source's hash is rebuilt
    (into a fresh directory here, so the shared build is left alone)."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", tmp_path / "libvslam_loader.so")
    monkeypatch.setattr(native, "_STAMP", tmp_path / "libvslam_loader.sha256")
    native._LIB.write_bytes(b"not a library")
    native._STAMP.write_text("stale")
    assert native._compile() == native._LIB
    assert native._STAMP.read_text() == native._source_hash()
    assert native._LIB.read_bytes()[:4] == b"\x7fELF"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libvslam_loader.sha256", "libvslam_loader.so"]


def test_decode_failure_raises(lib, tmp_path):
    """No Python decoder stands in for the loader: a file it cannot decode
    raises, and a directory without images refuses to open."""
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    with pytest.raises(IOError):
        decode_image(bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        NativeDatasetSource(empty)


def test_png_writer_reads_back_exactly(lib, tmp_path, rng):
    """``dataset_world.write_png``'s files read back through cv2 and through
    both packages' loaders exactly, and ``write_kitti`` writes the layout
    that ``NativeDatasetSource`` and the KITTI calibration read."""
    for shape in ((1, 1), (7, 13), (376, 1240)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        p = tmp_path / f"w{shape[0]}.png"
        dataset_world.write_png(p, img)
        np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(decode_image(p), img)
        np.testing.assert_array_equal(jnative.decode_image(p), img)
    frames = rng.normal(128.0, 90.0, (3, 20, 30))
    K = np.array([[300.0, 0, 15.5], [0, 300.0, 10.0], [0, 0, 1]])
    images, calib, u8 = dataset_world.write_kitti(tmp_path / "seq", frames, K)
    np.testing.assert_array_equal(u8, np.clip(np.rint(frames), 0, 255).astype(np.uint8))
    ds = NativeDatasetSource(images, fps=30.0)
    for i in range(3):
        f, ts = ds.get_frame()
        np.testing.assert_array_equal(f, u8[i].astype(np.float32))
        assert ts == i / 30.0
    ds.release()
    from visual_slam_tpu_torch.io.calibration import UniversalCalibration

    np.testing.assert_allclose(UniversalCalibration().load_from(calib).mono.K, K)
