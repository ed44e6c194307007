"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
host libraries (``csrc/*.cpp``).

Each CUDA source is compiled by ``nvcc`` for ``sm_90a``, each host source
by the C++ compiler (``c++`` or ``g++``, ``-O2``, no ``-ffast-math``), into
a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source and the ``csrc`` headers it includes (``#include "..."``), so a
changed source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: a kernel's wrapper builds its
library at its first launch, and ``build_all`` builds several in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
BUILD_DIR = REPO_ROOT / 'build' / 'torch_kernels'
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# --fmad=false: no multiply-add contraction, so a kernel rounds as its plain
# PyTorch version does (see csrc/tile_blend_fwd.cu)
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']
# host libraries: no -ffast-math, so the arithmetic is the source's
CXX_FLAGS = ['-std=c++17', '-O2', '-shared', '-fPIC']


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')


def cxx_path() -> str:
    for name in ('c++', 'g++'):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError('no C++ compiler (c++ or g++) found: the host '
                       'libraries build from their sources at first use')


class CudaLibrary:
    """One ``csrc`` source compiled to one shared library."""

    def __init__(self, source: str):
        self.source = PACKAGE_DIR / 'csrc' / source
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_info: Dict = {}

    def command(self, out: Path) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, '-o', str(out), str(self.source)]

    def files(self) -> List[Path]:
        """The source and, transitively, the headers beside it that it
        includes with quotes."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in found:
                continue
            found.append(path)
            for name in _LOCAL_INCLUDE.findall(path.read_text()):
                todo.append(path.parent / name)
        return found

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.files():
            h.update(path.read_bytes())
        return BUILD_DIR / f'lib{self.source.stem}_{h.hexdigest()[:12]}.so'

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library exists; returns the process."""
        if self.lib_path.exists():
            self.build_info = {'source': self._rel_source(), 'cached': True}
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.Popen(self.command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        proc.t0 = time.perf_counter()
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> Dict:
        if proc is None:
            return self.build_info
        out, _ = proc.communicate()
        seconds = time.perf_counter() - proc.t0
        if proc.returncode != 0:
            raise RuntimeError(f'{Path(proc.args[0]).name} failed for '
                               f'{self.source}:\n{out}')
        os.replace(proc.tmp_path, self.lib_path)
        ptxas = [ln.strip() for ln in out.splitlines()
                 if 'registers' in ln or 'smem' in ln or 'spill' in ln]
        self.build_info = {'source': self._rel_source(), 'cached': False,
                           'seconds': seconds, 'ptxas': ptxas}
        return self.build_info

    def load(self) -> ctypes.CDLL:
        with self._lock:  # the first use may come from several threads
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.lib_path))
        return self._lib

    def _rel_source(self) -> str:
        return str(self.source.relative_to(REPO_ROOT))


class HostLibrary(CudaLibrary):
    """One ``csrc`` C++ source for the host, compiled by ``c++``."""

    def command(self, out: Path) -> List[str]:
        return [cxx_path(), *CXX_FLAGS, '-o', str(out), str(self.source)]


def build_all(libraries: List[CudaLibrary]) -> List[Dict]:
    """Compile every library at once (one nvcc each) and load them."""
    procs = [lib.start_build() for lib in libraries]
    infos, errors = [], []
    for lib, proc in zip(libraries, procs):
        try:
            infos.append(lib.finish_build(proc))
        except RuntimeError as e:  # wait for the other builds first
            errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    for lib in libraries:
        lib.load()
    return infos
