"""Builds and loads the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library,
at first use, into ``_build/`` beside the sources (a directory git
ignores), and loaded with ``ctypes``. A library's file name carries a hash
of its source, of the ``csrc/*.cuh`` headers it includes and of the flags,
so an edited source or header is rebuilt and a built one is reused.
``build()`` starts one ``nvcc`` per source, all at once.

Every wrapper counts its kernel launches in ``LAUNCHES``: one per launch,
added where the kernel is launched and nowhere else, so a run can show
that its path went through the kernels. (One C call is one launch of its
kernel even where the kernel runs in two passes, as ``conv5x5_wgrad``'s
partial sums and their reduction do.)

Importing this module needs neither ``nvcc`` nor a GPU: nothing is built or
loaded until a wrapper meets a CUDA tensor.
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
from typing import Dict, Iterable, List

import torch

__all__ = ['LAUNCHES', 'KERNELS', 'build', 'launch', 'library_path',
           'reset_launches', 'source_path']

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / 'csrc'
BUILD_DIR = _PACKAGE_DIR / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (C symbol, argument types). Pointers and the stream are
# c_void_p: an int argument without argtypes would be cut to 32 bits.
KERNELS = {
    'crop_convert': ('t2r_crop_convert',
                     [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                      _I, _P]),
    'max_pool': ('t2r_max_pool',
                 [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P]),
    'max_pool_backward': ('t2r_max_pool_backward',
                          [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P]),
    'conv5x5_wgrad': ('t2r_conv5x5_wgrad',
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    'flash_attention_fwd': ('t2r_flash_attention_fwd',
                            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                            + [ctypes.c_longlong] * 9
                            + [ctypes.c_float, _I, _I, _P]),
    'flash_attention_bwd_kv': ('t2r_flash_attention_bwd_kv',
                               [_P] * 8 + [_I] * 5
                               + [ctypes.c_longlong] * 18
                               + [ctypes.c_float, _I, _I, _P]),
    'flash_attention_bwd_q': ('t2r_flash_attention_bwd_q',
                              [_P] * 7 + [_I] * 5
                              + [ctypes.c_longlong] * 15
                              + [ctypes.c_float, _I, _I, _P]),
    'flash_attention_carry': ('t2r_flash_attention_carry',
                              [_P] * 6 + [_I] * 5
                              + [ctypes.c_longlong] * 9
                              + [ctypes.c_float, _I, ctypes.c_longlong,
                                 ctypes.c_longlong, _I, _P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_functions: Dict[str, tuple] = {}


def source_path(name: str) -> Path:
  return CSRC_DIR / '{}.cu'.format(name)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> List[Path]:
  """``path`` and every header it includes from ``csrc/`` (``#include
  "name.cuh"``), recursively, each once, in the order first met."""
  found, todo = [], [path]
  while todo:
    current = todo.pop(0)
    if current in found:
      continue
    found.append(current)
    for name in _INCLUDE.findall(current.read_bytes()):
      header = current.parent / name.decode()
      if header.exists():
        todo.append(header)
  return found


def library_path(name: str) -> Path:
  """The built library's path: its name carries a hash of the source, of
  every ``csrc/`` header it includes and of the flags, so that an edit to
  any of them rebuilds it."""
  digest = hashlib.sha256()
  for path in _sources(source_path(name)):
    digest.update(path.name.encode() + b'\0' + path.read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / '{}-{}.so'.format(name, digest.hexdigest()[:16])


def _nvcc() -> str:
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  candidate = os.path.join(cuda_home, 'bin', 'nvcc')
  if os.path.exists(candidate):
    return candidate
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found (looked in {} and on PATH); the '
                       'CUDA kernels cannot be built.'.format(candidate))
  return found


def build(names: Iterable[str] = tuple(KERNELS)) -> float:
  """Compiles every named kernel not yet built; returns the seconds taken.

  One ``nvcc`` per source, all started together. Each library is written
  to a temporary name and renamed into place, so a reader never loads a
  half-written file. The compiler's output (``-Xptxas=-v``: registers,
  shared memory, spills) is kept in ``_build/<name>.log``.
  """
  start = time.monotonic()
  todo = [name for name in names if not library_path(name).exists()]
  if not todo:
    return time.monotonic() - start
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  jobs = []
  for name in todo:
    target = library_path(name)
    tmp = target.with_suffix('.so.tmp{}'.format(os.getpid()))
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(source_path(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jobs.append((name, target, tmp, proc))
  failures = []
  for name, target, tmp, proc in jobs:
    output, _ = proc.communicate()
    (BUILD_DIR / '{}.log'.format(name)).write_text(output)
    if proc.returncode != 0:
      failures.append('{}:\n{}'.format(name, output))
    else:
      os.replace(tmp, target)
  if failures:
    raise RuntimeError('nvcc failed for ' + '\n'.join(failures))
  return time.monotonic() - start


def _function(name: str):
  with _lock:
    loaded = _functions.get(name)
    if loaded is None:
      build([name])
      library = ctypes.CDLL(str(library_path(name)))
      symbol, argtypes = KERNELS[name]
      function = getattr(library, symbol)
      function.argtypes = argtypes
      function.restype = ctypes.c_int
      library.t2r_error_string.argtypes = [ctypes.c_int]
      library.t2r_error_string.restype = ctypes.c_char_p
      loaded = (function, library.t2r_error_string)
      _functions[name] = loaded
  return loaded


def launch(name: str, device: torch.device, *args) -> None:
  """Launches kernel ``name`` on ``device``'s current stream; counts it.

  ``args`` are the C function's arguments before the stream. Raises if the
  launch was refused (the status of ``cudaGetLastError()``).
  """
  function, error_string = _function(name)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = function(*args, stream)
  if status != 0:
    raise RuntimeError('CUDA kernel {} failed to launch: {}'.format(
        name, error_string(status).decode()))
  LAUNCHES[name] += 1


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0
