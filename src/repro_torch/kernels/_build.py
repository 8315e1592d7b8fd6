"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface, which ``ctypes`` loads. The library's
file name carries a hash of its source and flags, so an edited source
rebuilds and an unchanged one loads the library built before. Builds go
to ``repro_torch/_build/`` (listed in ``.gitignore``). All sources build
in parallel, one ``nvcc`` each. A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int

# argtypes of every exported C function, by source: every pointer and the
# stream are c_void_p (a plain int would be cut to 32 bits)
SIGNATURES = {
    "bfp_matmul": {
        # every variant: x, its payloads in _PAYLOADS order, out, out_dtype,
        # ws (f32 (S, M, N) or null), splits, M, K, N, ld, stream
        f"bfp_matmul_{variant}": [_c_void_p] * (1 + n_payloads) + [
            _c_void_p, _c_int, _c_void_p, _c_int,
            _c_int, _c_int, _c_int, _c_int, _c_void_p]
        for variant, n_payloads in (("q2_k", 4), ("q3_k", 4), ("q3_k_o", 6),
                                    ("q4_0", 2), ("q4_k", 5), ("q5_k", 6),
                                    ("q6_k", 4), ("q8_0", 2))
    } | {
        # M, N, splits: 1 if the launch writes split partials to ws
        "bfp_matmul_spreads_splits": [_c_int, _c_int, _c_int],
    },
    "prefill_attn": {
        # q, k, v, q_pos, kv_pos, out, q_dtype, kv_dtype, B, C, T, H, KH,
        # D, window, scale, softcap, stream
        "prefill_attn": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_void_p, _c_void_p, _c_int, _c_int,
                         _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                         _c_int, ctypes.c_float, ctypes.c_float, _c_void_p],
    },
    "q8k_quant": {
        # x, valid (or null), qs, d, bsums, x_dtype, M, K, stream
        "q8k_quantize": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                         _c_void_p, _c_int, _c_int, _c_int, _c_void_p],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # source name -> nvcc's output


def nvcc_path() -> str:
    cand = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cand.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing, all at once, and return name -> library path."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):"
                          f"\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])   # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
