"""Hand-written CUDA kernels, built with ``nvcc`` at first use and bound with
ctypes, and the native host code (the sampler and the partitioner), built
with ``g++`` at first use.

Each CUDA source in this directory is compiled on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library goes to ``pytorch_geometric_tpu_torch/_build/`` under a
name keyed by a hash of the source, the shared headers (``*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.

``sampler.cpp`` (the neighbour samplers of ``sampler/neighbor_sampler.py``
and ``sampler/hetero.py``, and the random walks of ``nn/models/node2vec.py``)
and ``partition.cpp`` (the multilevel partitioner of ``loader/cluster.py``)
are host code: :func:`sampler_library` and :func:`partition_library` build
each with ``g++`` into the same directory, keyed the same way and by the
host (it is built for the host's CPU), and ``WITH_NATIVE_SAMPLER`` says
whether the sampler is there. Where ``g++`` is missing or a build fails,
the callers take their numpy paths, as the JAX package's do (its
``csrc/__init__.py``).

Nothing here runs at import: the package imports on a machine without
``nvcc`` or a card, where only the plain versions of the kernels run;
``WITH_NATIVE_SAMPLER`` builds the sampler when it is first read.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / '_build'

# library name -> source file in this directory
SOURCES = {'segment_spmm': 'segment_spmm.cu', 'bsr_spmm': 'bsr_spmm.cu',
           'gat_mix': 'gat_mix.cu', 'segment_max': 'segment_max.cu',
           'sddmm': 'sddmm.cu', 'flash_softmax': 'flash_softmax.cu'}

# --split-compile=0: the device code is optimised on every core, so the
# flash source's template instances do not hold up the build
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '--split-compile=0')

# name -> nvcc's output of the build this process ran (the `-Xptxas -v`
# register and spill report)
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [Path(cuda_home) / 'bin' / 'nvcc'] if cuda_home else []
    found = shutil.which('nvcc')
    if found:
        candidates.append(Path(found))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError('nvcc was not found (looked in $CUDA_HOME/bin, PATH '
                       'and /usr/local/cuda/bin); the CUDA kernels cannot '
                       'be built')


def library_path(name: str) -> Path:
    src = SOURCE_DIR / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SOURCE_DIR.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Raises ``RuntimeError`` with
    the compiler's output if a build fails."""
    targets = {name: library_path(name) for name in names}
    todo = {name: t for name, t in targets.items() if not t.is_file()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in todo.items():
        # write under a name of this process, then rename: several
        # processes may build the same library at once
        tmp = target.with_name(f'{target.stem}.{os.getpid()}.tmp')
        procs[name] = (tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
             str(SOURCE_DIR / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'CUDA build of {name} failed (nvcc exit '
                          f'{proc.returncode}):\n{build_logs[name]}')
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError('\n'.join(failed))
    return targets


def build(name: str) -> Path:
    """Compile the library ``name`` unless it is built already."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of the library ``name`` (built first if
    needed), bound once with ``argtypes`` and an int result, the
    ``cudaGetLastError()`` every entry point returns."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


# -- the native host code -------------------------------------------------------
SAMPLER_SOURCE = 'sampler.cpp'
PARTITION_SOURCE = 'partition.cpp'
# the JAX package's flags (its csrc/__init__.py), so that both builds draw
# the same neighbours and walks and cut the same partitions; -march=native
# ties a library to the host's CPU
HOST_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')

_host_lock = threading.Lock()
_sampler: Optional[ctypes.CDLL] = None
_sampler_tried = False
_partition: Optional[ctypes.CDLL] = None
_partition_tried = False


def host_path(source: str = SAMPLER_SOURCE) -> Path:
    """Where the library of the host ``source`` in this directory, built
    with these flags on this host, goes."""
    h = hashlib.sha256((SOURCE_DIR / source).read_bytes())
    h.update(' '.join(HOST_FLAGS).encode())
    h.update(f'{platform.machine()} {platform.node()}'.encode())
    return BUILD_DIR / f'lib{Path(source).stem}-{h.hexdigest()[:16]}.so'


def build_host(source: str = SAMPLER_SOURCE) -> Path:
    """Compile the library of the host ``source`` unless it is built
    already. Raises ``RuntimeError`` with the compiler's output if ``g++``
    fails, ``FileNotFoundError`` where there is no ``g++`` and
    ``subprocess.TimeoutExpired`` past 300 s."""
    target = host_path(source)
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # write under a name of this process and thread, then rename: the test
    # workers, or a loader's threads, may all build it at once
    tmp = target.with_name(
        f'{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp')
    try:
        res = subprocess.run(['g++', *HOST_FLAGS, str(SOURCE_DIR / source),
                              '-o', str(tmp)], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f'g++ build of {source} failed (exit '
                               f'{res.returncode}):\n{res.stdout}'
                               f'{res.stderr}')
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


def sampler_path() -> Path:
    """Where the sampler library of this source, these flags and this host
    goes."""
    return host_path(SAMPLER_SOURCE)


def build_sampler() -> Path:
    """Compile the sampler library unless it is built already
    (:func:`build_host`)."""
    return build_host(SAMPLER_SOURCE)


def _load_host(source: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(str(build_host(source)))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None


def sampler_library() -> Optional[ctypes.CDLL]:
    """The sampler library with ``neighbor_sample``,
    ``hetero_neighbor_sample``, ``neighbor_sample_tw`` and ``random_walk``
    bound, built first if needed; ``None`` where it cannot be built (the
    samplers then take their numpy paths). Bound with ``ctypes.CDLL``, which
    releases the GIL for the length of a call."""
    global _sampler, _sampler_tried
    with _host_lock:
        if _sampler is not None or _sampler_tried:
            return _sampler
        _sampler_tried = True
        lib = _load_host(SAMPLER_SOURCE)
        if lib is None:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.neighbor_sample.restype = ctypes.c_int64
        lib.neighbor_sample.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64,          # csc, n
            i64p, ctypes.c_int64,                      # seeds
            i64p, ctypes.c_int64,                      # fanouts
            i64p, ctypes.c_int64, ctypes.c_int64,      # caps
            ctypes.c_int, ctypes.c_uint64,             # replace, seed
            i64p, u8p, i64p, i64p, i64p, u8p,          # outputs
            i64p, i64p,
        ]
        i64pp = ctypes.POINTER(i64p)
        u8pp = ctypes.POINTER(u8p)
        lib.hetero_neighbor_sample.restype = ctypes.c_int64
        lib.hetero_neighbor_sample.argtypes = [
            ctypes.c_int64, ctypes.c_int64,            # T, R
            i64pp, i64pp, i64pp,                       # colptrs, rows, eids
            i64p, i64p,                                # src_type, dst_type
            ctypes.c_int64, i64p, ctypes.c_int64,      # input_type, seeds
            i64p, ctypes.c_int64,                      # fanouts, H
            i64p, i64p,                                # n_caps, ecap_hop
            ctypes.c_int, ctypes.c_uint64,             # replace, seed
            i64pp, u8pp,                               # node_out, node_mask
            i64pp, i64pp, i64pp, u8pp,                 # row/col/eid/mask
            i64p, i64p,                                # nsn, nse
        ]
        lib.neighbor_sample_tw.restype = ctypes.c_int64
        lib.neighbor_sample_tw.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64,          # csc, n
            i64p, ctypes.c_int64, f64p,                # seeds, seed_time
            i64p, ctypes.c_int64,                      # fanouts
            i64p, ctypes.c_int64, ctypes.c_int64,      # caps
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # replace/disj/strat
            f64p, f64p, f64p,                          # node/edge time, w
            ctypes.c_uint64,                           # seed
            i64p, i64p, u8p,                           # node, batch, mask
            i64p, i64p, i64p, u8p,                     # row/col/eid/mask
            i64p, i64p,
        ]
        lib.random_walk.restype = None
        lib.random_walk.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64,  # csr, start
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,  # length, p, q
            ctypes.c_uint64, i64p,                             # seed, out
        ]
        _sampler = lib
        return _sampler


def partition_library() -> Optional[ctypes.CDLL]:
    """The partitioner library with ``multilevel_partition`` bound (the
    argument types of the JAX package's binding), built first if needed;
    ``None`` where it cannot be built (``loader/cluster.py`` then runs its
    numpy pipeline)."""
    global _partition, _partition_tried
    with _host_lock:
        if _partition is not None or _partition_tried:
            return _partition
        _partition_tried = True
        lib = _load_host(PARTITION_SOURCE)
        if lib is None:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.multilevel_partition.restype = None
        lib.multilevel_partition.argtypes = [
            i64p, i64p, f64p, ctypes.c_int64,       # csr, n
            ctypes.c_int64, ctypes.c_uint64,        # parts, seed
            ctypes.c_double, i32p,                  # imbalance, out
        ]
        _partition = lib
        return _partition


def __getattr__(name):
    # WITH_NATIVE_SAMPLER is read at call time (the samplers look it up on
    # this module), so that a test can set it, and so that importing the
    # package builds nothing
    if name == 'WITH_NATIVE_SAMPLER':
        return sampler_library() is not None
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
