"""The out-of-core data loader (port of mimo_tpu/io/loader.py): a
memory-mapped float32 matrix file with a multithreaded row gather.

The native backend is the repo's `native/loader.cc`, compiled by g++ with
`native/Makefile`'s flags into `build/mimo_tpu_torch/libmimo_loader.so`
at first use (rebuilt whenever the source's hash changes; nothing is
written into `native/`) and bound here with ctypes. Without a C++
toolchain, or with MIMO_TPU_TORCH_LOADER=numpy, the loader falls back,
with one warning, to its plain version: a NumPy memmap over the same
format, single-threaded.

File format: a 16-byte header {int64 rows, int64 cols}, then the rows,
row-major float32.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / 'native' / 'loader.cc'
BUILD_DIR = _ROOT / 'build' / 'mimo_tpu_torch'
LIB_NAME = 'libmimo_loader.so'
# native/Makefile's CXXFLAGS and link flag
FLAGS = ['-O3', '-fPIC', '-std=c++17', '-Wall', '-pthread', '-shared']
ENV = 'MIMO_TPU_TORCH_LOADER'

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_lib = None          # the loaded library, False after a failed build
_warned = False


def _build():
    """Compile native/loader.cc into BUILD_DIR unless an up-to-date
    library is there. Returns its path."""
    digest = hashlib.sha256(' '.join(FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + '.sha256')
    if (lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None:
        raise OSError('no C++ compiler (g++) to build the native loader')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f'{LIB_NAME}.{os.getpid()}.tmp'
    proc = subprocess.run([cxx] + FLAGS + ['-o', str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise OSError(f'building the native loader failed:\n{proc.stderr}')
    os.replace(tmp, lib)
    stamp.write_text(digest + '\n')
    return lib


def _load():
    """The native library; raises OSError when it cannot be had."""
    global _lib
    if os.environ.get(ENV) == 'numpy':
        raise OSError(f'{ENV}=numpy forces the NumPy backend')
    if _lib is False:
        raise OSError('native loader unavailable (a build failed before)')
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except OSError:
        _lib = False
        raise
    lib.mimo_open.restype = ctypes.c_void_p
    lib.mimo_open.argtypes = [ctypes.c_char_p, _I64P, _I64P]
    lib.mimo_close.argtypes = [ctypes.c_void_p]
    lib.mimo_gather.argtypes = [ctypes.c_void_p, _I64P, ctypes.c_int64,
                                _F32P, ctypes.c_int]
    lib.mimo_read_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, _F32P]
    lib.mimo_csv_to_bin.restype = ctypes.c_int64
    lib.mimo_csv_to_bin.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.mimo_write_bin.restype = ctypes.c_int64
    lib.mimo_write_bin.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64,
                                   ctypes.c_int64]
    _lib = lib
    return lib


def _native_or_none():
    """The native library, or None (with a one-time warning) when the
    NumPy backend must serve."""
    global _warned
    try:
        return _load()
    except OSError:
        if not _warned:
            warnings.warn(
                'mimo_tpu_torch.io: native loader unavailable (no C++ '
                'toolchain, or forced off); using the NumPy mmap backend '
                '(same format and API, single-threaded gather)',
                RuntimeWarning)
            _warned = True
        return None


def _f32p(arr):
    return arr.ctypes.data_as(_F32P)


def write_bin(path, array):
    """Write a float32 (N, d) array in the loader's binary format."""
    arr = np.ascontiguousarray(np.asarray(array, np.float32))
    if arr.ndim != 2:
        raise ValueError(
            f'write_bin needs a 2-D (N, d) array, got ndim={arr.ndim}: '
            'reshape 1-D data to (N, 1) first')
    lib = _native_or_none()
    if lib is None:
        with open(path, 'wb') as f:
            np.asarray(arr.shape, np.int64).tofile(f)
            arr.tofile(f)
        return path
    rows = lib.mimo_write_bin(str(path).encode(), _f32p(arr), arr.shape[0],
                              arr.shape[1])
    if rows != arr.shape[0]:
        raise IOError(f'failed to write {path}')
    return path


def csv_to_bin(csv_path, bin_path):
    """Convert a headerless numeric CSV to the binary format. Returns the
    row count."""
    lib = _native_or_none()
    if lib is None:
        arr = np.loadtxt(csv_path, delimiter=',', dtype=np.float32,
                         ndmin=2)
        write_bin(bin_path, arr)
        return int(arr.shape[0])
    rows = lib.mimo_csv_to_bin(str(csv_path).encode(),
                               str(bin_path).encode())
    if rows < 0:
        raise IOError(f'failed to parse {csv_path}')
    return int(rows)


class MmapDataset:
    """A memory-mapped float32 (rows, cols) matrix with O(1) open and a
    threaded gather. `backend` is 'native' or 'numpy'."""

    def __init__(self, path, n_threads=8):
        self._lib = _native_or_none()
        self._h = None
        self._mm = None
        path = str(path)
        if self._lib is None:
            hdr = np.fromfile(path, dtype=np.int64, count=2)
            if hdr.size != 2 or hdr[0] <= 0 or hdr[1] <= 0:
                raise IOError(f'cannot open dataset {path}')
            rows, cols = int(hdr[0]), int(hdr[1])
            if os.path.getsize(path) - 16 < 4 * rows * cols:
                raise IOError(f'cannot open dataset {path}: truncated')
            self._mm = np.memmap(path, dtype=np.float32, mode='r',
                                 offset=16, shape=(rows, cols))
            self.shape = (rows, cols)
        else:
            rows, cols = ctypes.c_int64(), ctypes.c_int64()
            self._h = self._lib.mimo_open(path.encode(), ctypes.byref(rows),
                                          ctypes.byref(cols))
            if not self._h:
                raise IOError(f'cannot open dataset {path}')
            self.shape = (rows.value, cols.value)
        self.backend = 'numpy' if self._lib is None else 'native'
        self.n_threads = n_threads

    def gather(self, indices):
        """Rows by index -> float32 (len(indices), cols). The native
        backend gives zero rows for out-of-range indices; the NumPy one
        raises IndexError."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if self._mm is not None:
            if idx.size and (idx.min() < 0 or idx.max() >= self.shape[0]):
                raise IndexError('gather index out of range')
            return np.asarray(self._mm[idx], np.float32)
        out = np.empty((idx.shape[0], self.shape[1]), np.float32)
        self._lib.mimo_gather(self._h, idx.ctypes.data_as(_I64P),
                              idx.shape[0], _f32p(out), self.n_threads)
        return out

    def read_block(self, start, count):
        """Rows [start, start + count), clipped at the end of the file."""
        if not 0 <= start < self.shape[0]:
            raise IndexError(
                f'start={start} out of range for {self.shape[0]} rows')
        if count <= 0:
            raise ValueError(f'count={count} must be positive')
        count = min(count, self.shape[0] - start)
        if self._mm is not None:
            return np.array(self._mm[start:start + count], np.float32)
        out = np.empty((count, self.shape[1]), np.float32)
        self._lib.mimo_read_block(self._h, start, count, _f32p(out))
        return out

    def sample(self, rng, batch_size):
        """One uniform minibatch without replacement (a numpy Generator's
        `choice`)."""
        idx = rng.choice(self.shape[0], size=batch_size, replace=False)
        return self.gather(idx)

    def minibatches(self, rng, batch_size, steps):
        for _ in range(steps):
            yield self.sample(rng, batch_size)

    def close(self):
        if self._h:
            self._lib.mimo_close(self._h)
            self._h = None
        self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
