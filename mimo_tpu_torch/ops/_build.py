"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/.../<name>.o csrc/<name>.cu
    nvcc -shared -o build/mimo_tpu_torch/libmimo_kernels.so build/.../*.o

The library lands under `build/` beside the package and is rebuilt
whenever the hash of the sources (and of the flags) changes. Nothing is
downloaded: the only headers are the CUDA toolkit's. The build runs at
first use, never at import, so the CPU-only tests import every module.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'mimo_tpu_torch'
LIB_NAME = 'libmimo_kernels.so'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> (restype, argtypes) of every C entry point
_SIGNATURES = {
    'mimo_estep': (_I, [_P, _I64, _I, _I, _I, _I64, _P, _I, _I, _P, _P, _I,
                        _P]),
    'mimo_gibbs': (_I, [_P, _I64, _I, _I, _I, _I64, _P, _I, _I, _P, _P, _P,
                        _P, _I, _P]),
    'mimo_predict': (_I, [_P, _I64, _I, _I, _I, _I64, _P, _I, _I, _P, _I,
                          _P, _P]),
    'mimo_diag_predict': (_I, [_P, _I64, _I, _I, _I64, _P, _I, _P, _P, _P]),
    'mimo_ilr_predict': (_I, [_P, _I64, _I, _I, _I64, _P, _I, _I, _P, _I,
                              _P, _P]),
    'mimo_ilr_p_predict': (_I, [_P, _I64, _I, _I, _I, _I, _I64, _P, _I, _I,
                                _P, _P, _I, _P, _P, _P]),
    'mimo_regf': (_I, [_P, _I64, _I, _I64, _P, _I, _I, _I, _P, _P, _P]),
    'mimo_estep_count': (_I, [_P, _I64, _I, _I64, _P, _I, _P, _I, _I, _P,
                              _P, _P]),
    'mimo_hello': (_I, [_P, _I64, _P, _P]),
    'mimo_gumbel_fast': (_I, [_P, _P]),
    'mimo_estep_scratch': (_I64, [_I, _I, _I, _I64, _I]),
    'mimo_gibbs_scratch': (_I64, [_I, _I, _I, _I64, _I]),
    'mimo_probe_scratch': (_I64, [_I, _I, _I, _I64]),
    'mimo_error_string': (ctypes.c_char_p, [_I]),
}


class KernelLibrary:
    """The loaded kernels. `build_seconds` is the wall time of this
    process's nvcc runs (0.0 when an up-to-date library was reused);
    `logs` maps each source's name to nvcc's output for it (-Xptxas -v:
    registers and shared memory per kernel)."""

    def __init__(self, path, build_seconds, logs):
        self.path = path
        self.build_seconds = build_seconds
        self.logs = logs
        self._lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
            setattr(self, name, fn)

    def check(self, rc, what):
        """Raise if a C entry point returned a CUDA error code."""
        if rc != 0:
            msg = self.mimo_error_string(rc).decode()
            raise RuntimeError(f'{what}: CUDA error {rc}: {msg}')


_loaded = None


def check_inputs(what, xt, n, theta, width, desc):
    """Validate a kernel wrapper's inputs before any pointer reaches C.

    xt: (rows, >=n) float32 CUDA tensor with contiguous rows; theta: the
    (R, m8) float32 coefficient rows on the same device, whose m8 columns
    must hold the `width` features of the map the kernel assembles
    (`desc` names that map and its dimensions for the messages)."""
    if not xt.is_cuda:
        raise ValueError(f'{what}: the kernel needs CUDA tensors')
    if xt.dim() != 2 or xt.stride(1) != 1:
        raise ValueError(f'{what}: xt must be (rows, N) with contiguous rows')
    if not 0 <= n <= xt.shape[1]:
        raise ValueError(f'{what}: n={n} outside [0, {xt.shape[1]}]')
    for t in (xt, theta):
        if t.dtype != torch.float32:
            raise TypeError(f'{what}: the kernel takes float32, got '
                            f'{t.dtype}')
    if theta.device != xt.device:
        raise ValueError(f'{what}: inputs on {theta.device} and {xt.device}')
    if theta.dim() != 2 or not theta.is_contiguous():
        raise ValueError(f'{what}: coefficients must be contiguous (R, m8)')
    if theta.shape[1] < width:
        raise ValueError(f'{what}: {theta.shape[1]} coefficient columns '
                         f'cannot hold the {width} features of the {desc}')


def check_serving(what, xt, n, theta, width, desc, aux=None):
    """check_inputs for a serving kernel (B3-B6), which takes every K and
    d (csrc/serving.cuh streams the coefficients in K-chunks): theta's m8
    columns must be a multiple of 8 and theta and the (K, 8) aux rows
    16-byte aligned (the kernels read rows as float4)."""
    check_inputs(what, xt, n, theta, width, desc)
    if theta.shape[1] % 8:
        raise ValueError(f'{what}: {theta.shape[1]} coefficient columns, '
                         'not a multiple of 8')
    for t in (theta, aux):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f'{what}: coefficients must be 16-byte aligned')


def tc_scratch(what, lib, scratch_fn, xt, n, theta, desc, *args):
    """The scratch buffer of B1, B2 or a probe at this shape: theta (K,
    m8), or (C, K, m8) for C chains; `scratch_fn` the kernel's
    `mimo_*_scratch` (its floats at (K, m8, rows, n, *args)). Every shape
    has a layout (csrc/tc.cuh: plain, or streamed past the plain
    layout's shared memory); only scratch past the card's device memory
    raises NotImplementedError, naming the bytes."""
    k, m8 = theta.shape[-2:]
    with torch.cuda.device(xt.device):
        floats = scratch_fn(k, m8, xt.shape[0], n, *args)
    if floats < 0:
        lib.check(-floats, what)
    props = torch.cuda.get_device_properties(xt.device)
    if 4 * floats > props.total_memory:
        raise NotImplementedError(
            f'{what}: coefficients of shape (K, m8) = ({k}, {m8}) ({desc})'
            f'{"" if not args else f", {args[0]} chain(s)"} need {4 * floats} '
            f'bytes of scratch, above the {props.total_memory} bytes of '
            f'device memory of {props.name}')
    return torch.empty((floats,), dtype=torch.float32, device=xt.device)


def _nvcc():
    for root in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH to build the mimo_tpu_torch kernels')
    return found


def _sources():
    return sorted(glob.glob(str(SRC_DIR / '*.cu'))
                  + glob.glob(str(SRC_DIR / '*.cuh')))


def _digest(cmd_flags):
    h = hashlib.sha256(' '.join(cmd_flags).encode())
    for path in _sources():
        h.update(Path(path).name.encode())
        h.update(Path(path).read_bytes())
    return h.hexdigest()


def _run_all(cmds):
    """Start every command at once, wait for all; raise on the first
    failure with its output. Returns each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{out}')
    return outs


def load():
    """Build (if the sources changed) and load the kernel library."""
    global _loaded
    if _loaded is not None:
        return _loaded
    flags = ARCH_FLAGS + FLAGS
    digest = _digest(flags)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + '.sha256')
    seconds, logs = 0.0, {}
    if not (lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        nvcc = _nvcc()
        obj_dir = BUILD_DIR / f'obj.{os.getpid()}'
        obj_dir.mkdir(parents=True, exist_ok=True)
        cus = [s for s in _sources() if s.endswith('.cu')]
        objs = [obj_dir / (Path(s).stem + '.o') for s in cus]
        tmp = BUILD_DIR / f'{LIB_NAME}.{os.getpid()}.tmp'
        t0 = time.perf_counter()
        outs = _run_all([[nvcc] + flags + ['-c', '-o', str(o), s]
                         for s, o in zip(cus, objs)])
        _run_all([[nvcc] + ARCH_FLAGS + ['-shared', '-o', str(tmp)]
                  + [str(o) for o in objs]])
        seconds = time.perf_counter() - t0
        logs = {Path(s).name: out for s, out in zip(cus, outs)}
        os.replace(tmp, lib)
        shutil.rmtree(obj_dir)
        stamp.write_text(digest + '\n')
        (BUILD_DIR / 'build.log').write_text(
            ''.join(f'== {name}\n{out}' for name, out in logs.items()))
    _loaded = KernelLibrary(lib, seconds, logs)
    return _loaded
