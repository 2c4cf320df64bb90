"""EXR writer/reader roundtrip (replacement for core/exrio.cpp)."""
import numpy as np

from prt.io import exr


def test_roundtrip_half_zips(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 4, (17, 23, 3)).astype(np.float32)
    a = rng.uniform(0, 1, (17, 23)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    exr.write_exr(p, img, a)
    rgb, alpha = exr.read_exr(p)
    # Half precision: ~3 decimal digits.
    assert np.allclose(rgb, img, atol=2e-2, rtol=1e-2)
    assert np.allclose(alpha, a, atol=1e-2)


def test_roundtrip_float_none(tmp_path):
    img = np.arange(5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3) / 10.0
    p = str(tmp_path / "t2.exr")
    exr.write_exr(p, img, compression=0, half=False)
    rgb, alpha = exr.read_exr(p)
    assert alpha is None
    assert np.allclose(rgb, img)


def test_data_window_offset(tmp_path):
    """Crop-window renders carry their offset (exrassemble flow)."""
    img = np.ones((4, 6, 3), np.float32)
    p = str(tmp_path / "t3.exr")
    exr.write_exr(p, img, data_offset=(10, 20), display_window=(0, 0, 63, 63))
    rgb, _ = exr.read_exr(p)
    assert rgb.shape == (4, 6, 3)
