"""Hand-written CUDA kernels, built with ``nvcc`` at first use and bound with
ctypes.

Each source in this directory is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library goes to ``pytorch_geometric_tpu_torch/_build/`` under a name keyed by
a hash of the source, the shared headers (``*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.

Nothing here runs at import: the package imports on a machine without
``nvcc`` or a card, where only the plain versions of the kernels run.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / '_build'

# library name -> source file in this directory
SOURCES = {'segment_spmm': 'segment_spmm.cu', 'bsr_spmm': 'bsr_spmm.cu',
           'gat_mix': 'gat_mix.cu', 'segment_max': 'segment_max.cu',
           'sddmm': 'sddmm.cu'}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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
