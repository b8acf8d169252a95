"""Build the CUDA sources under ``csrc/`` into one shared library at first
use, and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so ``nvcc``
compiles it in seconds.  It lands in ``<build root>/<hash>/``, keyed by a
hash of the sources, the headers they share (``csrc/*.cuh``) and the
flags, so an edited source rebuilds and an unchanged one loads the cached
library.  The build root is
``$FORA_TPU_TORCH_BUILD_DIR`` when set, else ``build/fora_tpu_torch/`` in
a source checkout (the directory holding ``pyproject.toml`` beside the
package), else ``~/.cache/fora_tpu_torch`` for an installed package.
A missing ``nvcc`` or a failed compile raises: nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
LIB_NAME = "libfora_tpu_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# name -> argtypes of every C entry point: each returns a cudaError_t as an
# int, but the host-side fora_build_alias (0 or -1) and fora_parse_edges (a
# long long: the edge count, or a negative error)
SIGNATURES = {
    "fora_push_prepass": [_P, _P, _P, _P, _P, _P, _F, _F, _LL, _I, _P],
    "fora_backward_prepass": [_P, _P, _P, _F, _P, _F, _F, _F, _LL, _I, _P],
    "fora_gather_scatter_add": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                                _P, _P, _LL, _P, _P, _P, _P, _I, _I, _P],
    "fora_topk_segment": [],
    "fora_topk_bounds": [_P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P, _LL,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "fora_index_walk": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _I,
                        ctypes.c_ulonglong, _F, _I, _I, _LL, _P],
    "fora_index_walk_sharded": [_P, _P, _LL, _P, _P, _P, _P, _I, _I,
                                ctypes.c_ulonglong, _F, _I, _I, _LL, _P],
    "fora_raw_walk": [_P, _LL, _P, _LL, _P, _P, _I, _LL, _I, _LL, _LL, _I,
                      _P, _LL, _P, _P, _P, _P, _P, ctypes.c_ulonglong, _F,
                      _I, _I, _LL, _LL, _P],
    "fora_raw_walk_xp": [_P, _LL, _P, _LL, _P, _I, _LL, _I, _LL, _LL, _I,
                         _I, _I, _I, _P, _LL, _P, _P, _LL, _P, _P, _P, _P,
                         _P, ctypes.c_ulonglong, _F, _I, _I, _LL, _LL, _P],
    "fora_raw_walk_xp_inbox": [_P, _LL, _I, _I, _I, _I, _I, _I, _P, _LL, _P,
                               _P, _LL, _P, _P, _P, _P, _P,
                               ctypes.c_ulonglong, _I, _LL, _P],
    "fora_index_walk_xp": [_P, _LL, _LL, _P, _LL, _LL, _LL,
                           ctypes.c_ulonglong, _I, _I, _I, _I, _I, _I, _P,
                           _LL, _P, _P, _P, _P, _P, ctypes.c_ulonglong, _F,
                           _I, _I, _LL, _P],
    "fora_index_walk_xp_inbox": [_P, _LL, _P, _LL, _LL, _LL,
                                 ctypes.c_ulonglong, _I, _I, _I, _I, _I, _I,
                                 _P, _LL, _P, _P, _P, _P, _P,
                                 ctypes.c_ulonglong, _I, _LL, _P],
    "fora_source_walk": [_P, _I, _P, _LL, _LL, _P, _LL, _P, _P, _P, _P, _P,
                         _P, _I, ctypes.c_ulonglong, _F, _I, _F, _I, _LL,
                         _LL, _P],
    "fora_build_alias": [_P, _P, _P, _LL, _P, _P],
    "fora_parse_edges": [ctypes.c_char_p, _I, _P, _P, _P, _LL],
    "fora_ring_copy": [_P, _P, _LL, _P],
    "fora_ring_add": [_P, _P, _P, _LL, _P],
    "fora_reduce_scatter_onepass": [_P, _P, _I, _LL, _P],
    "fora_row_scatter_add": [_P, _P, _P, _P, _LL, _LL, _I, _P],
    "fora_exchange_clear": [_P, _P, _P, _I, _LL, _I, _LL, _LL, _P],
    "fora_frontier_compact": [_P, _LL, _I, _P, _I, _I, _LL, _I, _P, _LL, _P,
                              _LL, _P, _I, _P],
    "fora_frontier_prepass": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _LL, _I,
                              _I, _P, _P, _P],
    "fora_frontier_push": [_P, _P, _P, _LL, _P, _I, _P],
    "fora_walk_demand": [_P, _I, _LL, _LL, _I, _F, _P, _LL, _P, _P, _I,
                         _P],
    "fora_expand_lanes": [_P, _LL, _P, _LL, _P, _P, _I, _LL, _I, _LL, _LL,
                          _I, _P, _P, _P],
    "fora_accumulate_endpoints": [_P, _P, _F, _LL, _I, _P, _I, _LL, _P, _LL,
                                  _LL, _I, _P],
    "fora_enable_peer_access": [_I, _I],
    "fora_sector_reads": [_P, _LL, _I, _I, _P, ctypes.c_uint, _P],
    "fora_row_reads": [_P, _LL, _I, _I, _P, ctypes.c_uint, _P],
    "fora_philox_blocks": [_P, _I, _I, ctypes.c_uint, _P],
    "fora_pack_keys": [_P, _P, _LL, _P, _LL, _LL, _I, _P, _P, _I, _P],
    "fora_pack_key_counts": [_P, _P, _LL, _P, _LL, _LL, _I, ctypes.c_ulonglong,
                             ctypes.c_ulonglong, _I, _P, _P],
    "fora_pack_keys_window": [_P, _P, _LL, _P, _LL, _LL, _I,
                              ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _LL,
                              _P, _P, _I, _P],
    "fora_digit_counts": [_P, _LL, _I, _I, _P, _P],
    "fora_sort_keys": [_P, _P, _LL, _I, _I, _P, _LL, _P, ctypes.POINTER(_I),
                       _P],
    "fora_merge_keys": [_P, _LL, _I, _LL, _P, _LL, _P, _P, _P, _P, _P,
                        ctypes.POINTER(_LL), _P],
}

_lib: Optional[ctypes.CDLL] = None
last_build_secs: Optional[float] = None   # None: the cached library loaded


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def build_root() -> Path:
    """Where compiled libraries go (see the module docstring)."""
    env = os.environ.get("FORA_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "fora_tpu_torch"
    return Path.home() / ".cache" / "fora_tpu_torch"


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sources() + headers():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_root() / h.hexdigest()[:16] / LIB_NAME


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "fora_tpu_torch are built from source at first use")


def build() -> Path:
    """Compile csrc/*.cu into the hashed library path unless it exists:
    one nvcc per source, all started together, then one link.  The
    compilers' output (register and shared-memory use per kernel, from
    -Xptxas -v) is kept beside the library as nvcc.log."""
    global last_build_secs
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = so.parent / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out[-4000:]}")
    tmp = so.with_name(f".{LIB_NAME}.{tag}")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (so.parent / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    last_build_secs = time.perf_counter() - t0
    return so


def load_alone(src: Path, signatures: dict) -> ctypes.CDLL:
    """``src`` compiled alone with this package's flags into a library of
    its own under the build root, cached by a hash of the flags, ``src``
    and this package's sources (which ``src`` may include), and loaded
    with ctypes; each entry point named in ``signatures`` gets those
    argtypes and an int result.  For probes that time another form of a
    kernel beside this package's.  The compiler's output (each kernel's
    registers and spills) is kept beside the library as nvcc.log."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    for f in sources() + headers():
        h.update(f.read_bytes())
    so = build_root() / f"probe-{h.hexdigest()[:16]}" / "libother.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".libother.{os.getpid()}.tmp")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        (so.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _LL if name == "fora_parse_edges" else ctypes.c_int
        lib.fora_error_string.argtypes = [ctypes.c_int]
        lib.fora_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
