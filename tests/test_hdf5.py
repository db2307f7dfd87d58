"""The numpy HDF5 palette reader/writer against h5py (each reads the other's
files), its loud refusals, and the Pillow image I/O."""

import numpy as np
import pytest

from dmnerf_tpu.data.hdf5 import read_dataset, write_dataset
from dmnerf_tpu.utils.image_io import imread, imwrite

h5py = pytest.importorskip("h5py")

ARRAYS = [
    np.arange(18, dtype=np.uint8).reshape(6, 3),            # a DM-SR palette
    (np.arange(96) * 37 % 256).astype(np.uint8).reshape(32, 3),
    np.arange(-5, 5, dtype=np.int32),
    np.arange(24, dtype=np.int64).reshape(2, 3, 4),
]


@pytest.mark.parametrize("a", ARRAYS, ids=lambda a: f"{a.dtype}{list(a.shape)}")
def test_write_then_h5py_reads(tmp_path, a):
    path = str(tmp_path / "ins_rgb.hdf5")
    write_dataset(path, a)
    with h5py.File(path, "r") as f:
        got = f["datasets"][:]
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(read_dataset(path), a)


@pytest.mark.parametrize("a", ARRAYS + [np.random.RandomState(0).rand(4, 3).astype(np.float32)],
                         ids=lambda a: f"{a.dtype}{list(a.shape)}")
def test_read_h5py_file(tmp_path, a):
    path = str(tmp_path / "ins_rgb.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("datasets", data=a)
    got = read_dataset(path)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


def test_read_among_many_datasets(tmp_path):
    """Enough names that the root group needs several symbol-table nodes."""
    path = str(tmp_path / "many.hdf5")
    with h5py.File(path, "w") as f:
        for i in range(40):
            f.create_dataset(f"k{i}", data=np.arange(i + 1))
    np.testing.assert_array_equal(read_dataset(path, "k37"), np.arange(38))
    with pytest.raises(KeyError, match="no dataset"):
        read_dataset(path, "datasets")


@pytest.mark.parametrize("kind", ["compressed", "latest_format", "not_hdf5"])
def test_unsupported_files_raise(tmp_path, kind):
    path = str(tmp_path / "x.hdf5")
    if kind == "compressed":
        with h5py.File(path, "w") as f:
            f.create_dataset("datasets", data=np.arange(1000), chunks=(100,),
                             compression="gzip")
    elif kind == "latest_format":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("datasets", data=np.arange(10))
    else:
        with open(path, "wb") as f:
            f.write(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="hdf5"):
        read_dataset(path)


def test_write_rejects_float(tmp_path):
    with pytest.raises(ValueError, match="integer"):
        write_dataset(str(tmp_path / "x.hdf5"), np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("shape", [(7, 5, 3), (7, 5, 4), (7, 5)])
def test_png_round_trip(tmp_path, shape):
    img = (np.arange(np.prod(shape)) * 7 % 256).astype(np.uint8).reshape(shape)
    path = str(tmp_path / "x.png")
    imwrite(path, img)
    got = imread(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


def test_palette_png_reads_as_rgb(tmp_path):
    from PIL import Image

    rgb = (np.arange(7 * 5 * 3) % 4 * 60).astype(np.uint8).reshape(7, 5, 3)
    path = str(tmp_path / "p.png")
    Image.fromarray(rgb).quantize(colors=256).save(path)
    got = imread(path)
    assert got.shape == (7, 5, 3)
    np.testing.assert_array_equal(got, rgb)
