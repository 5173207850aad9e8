"""The port's out-of-core loader and reader thread (mimo_tpu_torch/io)
against mimo_tpu.io on the CPU: the file format byte for byte, gather and
read_block, the csv conversion, the NumPy backend, and Prefetcher's
semantics, including the end of the stream, which must not hang."""

import shutil
import threading

import numpy as np
import pytest

import mimo_tpu.io.loader as jloader
from mimo_tpu.io.stream import Prefetcher as JPrefetcher

import mimo_tpu_torch.io.loader as tloader
from mimo_tpu_torch.io import MmapDataset, Prefetcher, csv_to_bin, write_bin


@pytest.fixture(scope='module')
def toolchain():
    if shutil.which('g++') is None:
        pytest.skip('no C++ toolchain for the native loader')


@pytest.fixture(scope='module')
def dataset(toolchain, tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 3))
    path = str(tmp_path_factory.mktemp('io') / 'x.bin')
    write_bin(path, x)
    return path, x.astype(np.float32)


def test_write_bin_is_byte_identical_to_jax(dataset, tmp_path):
    path, x = dataset
    jpath = str(tmp_path / 'j.bin')
    jloader.write_bin(jpath, x)
    with open(path, 'rb') as a, open(jpath, 'rb') as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match='2-D'):
        write_bin(str(tmp_path / 'bad.bin'), x[:, 0])


def test_native_library_is_built_into_build(dataset):
    ds = MmapDataset(dataset[0])
    assert ds.backend == 'native'
    ds.close()
    assert (tloader.BUILD_DIR / tloader.LIB_NAME).exists()
    assert tloader.BUILD_DIR.parts[-2:] == ('build', 'mimo_tpu_torch')
    stamp = tloader.BUILD_DIR / (tloader.LIB_NAME + '.sha256')
    assert len(stamp.read_text().strip()) == 64


@pytest.mark.parametrize('idx', [[0, 5, 4999, 123, 5, 0], list(range(64)),
                                 [4999] * 9])
def test_gather_and_read_block_equal_jax(dataset, idx):
    path, x = dataset
    ds, jds = MmapDataset(path), jloader.MmapDataset(path)
    assert ds.shape == jds.shape == x.shape
    idx = np.asarray(idx)
    np.testing.assert_array_equal(ds.gather(idx), jds.gather(idx))
    np.testing.assert_array_equal(ds.gather(idx), x[idx])
    for start, count in ((0, 100), (100, 50), (4990, 100), (4999, 1)):
        np.testing.assert_array_equal(ds.read_block(start, count),
                                      jds.read_block(start, count))
    ds.close()
    jds.close()


def test_out_of_range_gives_zero_rows_and_bad_blocks_raise(dataset):
    ds = MmapDataset(dataset[0])
    got = ds.gather(np.array([-1, 5000, 3]))
    assert (got[:2] == 0).all() and (got[2] == dataset[1][3]).all()
    with pytest.raises(IndexError):
        ds.read_block(5000, 1)
    with pytest.raises(ValueError):
        ds.read_block(0, 0)
    ds.close()


def test_sample_and_minibatches_follow_the_numpy_generator(dataset):
    path, x = dataset
    ds = MmapDataset(path)
    got = list(ds.minibatches(np.random.default_rng(4), 32, 3))
    rng = np.random.default_rng(4)
    for b in got:
        np.testing.assert_array_equal(
            b, x[rng.choice(x.shape[0], size=32, replace=False)])
    ds.close()


def test_csv_roundtrip_equals_jax(toolchain, tmp_path):
    arr = np.random.default_rng(1).standard_normal((100, 3))
    csv = str(tmp_path / 'd.csv')
    np.savetxt(csv, arr, delimiter=',', fmt='%.6f')
    assert csv_to_bin(csv, str(tmp_path / 't.bin')) == 100
    assert jloader.csv_to_bin(csv, str(tmp_path / 'j.bin')) == 100
    assert ((tmp_path / 't.bin').read_bytes()
            == (tmp_path / 'j.bin').read_bytes())
    ds = MmapDataset(str(tmp_path / 't.bin'))
    np.testing.assert_allclose(ds.read_block(0, 100), arr, atol=1e-5)
    ds.close()


def test_numpy_backend_equals_native(dataset, tmp_path, monkeypatch):
    path, x = dataset
    native = MmapDataset(path)
    idx = np.asarray([0, 5, 4999, 7, 7])
    g, b = native.gather(idx), native.read_block(100, 64)
    native.close()
    monkeypatch.setenv(tloader.ENV, 'numpy')
    monkeypatch.setattr(tloader, '_warned', False)
    with pytest.warns(RuntimeWarning, match='NumPy'):
        ds = MmapDataset(path)
    assert ds.backend == 'numpy' and ds.shape == x.shape
    np.testing.assert_array_equal(ds.gather(idx), g)
    np.testing.assert_array_equal(ds.read_block(100, 64), b)
    with pytest.raises(IndexError):
        ds.gather(np.asarray([5000]))
    p2 = str(tmp_path / 'np.bin')
    write_bin(p2, x[:100])
    csv = str(tmp_path / 't.csv')
    np.savetxt(csv, x[:50], delimiter=',', fmt='%.6f')
    assert csv_to_bin(csv, str(tmp_path / 't.bin')) == 50
    ds.close()
    monkeypatch.delenv(tloader.ENV)
    ds2 = MmapDataset(p2)                   # native reads numpy-written
    assert ds2.backend == 'native'
    np.testing.assert_array_equal(ds2.read_block(0, 100), x[:100])
    ds2.close()


def test_bad_files_raise(toolchain, tmp_path):
    p = tmp_path / 'short.bin'
    p.write_bytes(np.asarray([10, 3], np.int64).tobytes() + b'\0' * 8)
    with pytest.raises(IOError):
        MmapDataset(str(p))
    with pytest.raises(IOError):
        MmapDataset(str(tmp_path / 'missing.bin'))


# -- Prefetcher ---------------------------------------------------------------

@pytest.mark.parametrize('depth', [1, 2, 5])
def test_prefetcher_keeps_order_as_jax(depth):
    with Prefetcher(lambda i: i * i, 10, depth=depth) as pf:
        got = list(pf)
    with JPrefetcher(lambda i: i * i, 10, depth=depth) as jpf:
        assert got == list(jpf) == [i * i for i in range(10)]


def test_prefetcher_reraises_producer_errors():
    def boom(i):
        if i == 3:
            raise ValueError('bad block')
        return i

    got = []
    with pytest.raises(ValueError, match='bad block'):
        with Prefetcher(boom, 10, depth=2) as pf:
            for v in pf:
                got.append(v)
    assert got == [0, 1, 2]


def _within(fn, seconds=5.0):
    """Run fn on a thread; fail (rather than hang the suite) if it does
    not return within `seconds`. Returns what fn raised, or None."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:   # noqa: BLE001
            out['err'] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), 'Prefetcher.get() hung'
    return out.get('err')


def test_get_after_the_end_raises_again_and_does_not_hang():
    pf = Prefetcher(lambda i: i, 3)
    assert [pf.get() for _ in range(3)] == [0, 1, 2]
    for _ in range(3):
        assert isinstance(_within(pf.get), StopIteration)
    pf.close()
    assert isinstance(_within(pf.get), StopIteration)


def test_get_after_an_error_raises_stop_iteration():
    def boom(i):
        raise KeyError('x')

    pf = Prefetcher(boom, 4)
    assert isinstance(_within(pf.get), KeyError)
    assert isinstance(_within(pf.get), StopIteration)
    pf.close()


def test_close_mid_stream_is_safe():
    seen = []

    def slow(i):
        seen.append(i)
        return np.zeros(1000)

    pf = Prefetcher(slow, 1000, depth=2)
    pf.get()
    assert _within(pf.close) is None
    assert len(seen) < 1000
    assert isinstance(_within(pf.get), StopIteration)


def test_prefetcher_keeps_order_under_frequent_thread_switches():
    """A stress run: many items through a one-deep queue with the
    interpreter switching threads every microsecond; every item arrives
    once, in order, within the time bound."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []

        def consume():
            with Prefetcher(lambda i: (i, np.full(8, i)), 3000, depth=1) as pf:
                got.extend(i for i, _ in pf)

        assert _within(consume, 30.0) is None
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(3000))
