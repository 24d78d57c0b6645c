"""Build and load the port's hand-written CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface, bound with `ctypes`. The build runs at
first use, on the machine with the card, all sources at once (one `nvcc`
per source), into `_build/<hash>/` inside the package; the hash covers the
sources, the headers, the flags and the compiler, so an edit rebuilds and an
unchanged tree loads what was built. `_build/` is listed in `.gitignore`.

Nothing here runs when the package is imported: the CPU paths never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

# library name -> source file; every library includes every header
SOURCES = {
    "fused_block": "fused_block.cu",
    "fused_block_train": "fused_block_train.cu",
    "fused_block_v2": "fused_block_v2.cu",
    "window_attention": "window_attention.cu",
}
HEADERS = ("common.cuh", "block_fwd.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (argtypes, restype)
SIGNATURES = {
    "fused_block": {
        "trr_attn_block_fwd": ([_P] * 10 + [_I] * 7 + [_F, _F, _P], _I),
        "trr_ln_mlp_fwd": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
        "trr_attn_block_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "trr_ln_mlp_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "fused_block_train": {
        "trr_swin_block_fwd": ([_P] * 20 + [_I] * 8 + [_F, _F, _P], _I),
        "trr_block_bwd_tokens": ([_P] * 24 + [_I] * 5 + [_F, _P], _I),
        "trr_block_bwd_attn": ([_P] * 7 + [_I] * 6 + [_F, _P], _I),
        "trr_block_bwd_ln1": ([_P] * 8 + [_I] * 4 + [_P], _I),
        "trr_weight_grad": ([_P] * 2 + [_I] * 4 + [_P, _P], _I),
        "trr_sum_rows": ([_P, _I, _I, _P, _P], _I),
        "trr_dbias": ([_P] + [_I] * 5 + [_P, _P], _I),
        "trr_ln_mlp_bwd_tokens": ([_P] * 15 + [_I] * 5 + [_F, _P], _I),
        "trr_bwd_tokens_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "trr_bwd_attn_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "trr_bwd_ln1_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "fused_block_v2": {
        "trr_cos_attn_fwd": ([_P] * 14 + [_I] * 7 + [_F, _P], _I),
        "trr_cos_attn_bwd": ([_P] * 16 + [_I] * 7 + [_F, _P], _I),
        "trr_pn_mlp_fwd": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
        "trr_pn_mlp_bwd": ([_P] * 15 + [_I] * 5 + [_F, _P], _I),
        "trr_cos_attn_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "trr_pn_mlp_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "trr_postnorm_ln_bwd_smem_bytes": ([_I], ctypes.c_size_t),
        "trr_cos_attn_bwd_smem_bytes": ([_I], ctypes.c_size_t),
        "trr_qkv_dx_smem_bytes": ([_I], ctypes.c_size_t),
        "trr_pn_mlp_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    },
    "window_attention": {
        "trr_window_mhsa_fwd": ([_P] * 3 + [_I] * 7 + [_F, _P], _I),
        "trr_window_mhsa_bwd": ([_P] * 6 + [_I] * 7 + [_F, _P], _I),
        "trr_window_mhsa_smem_bytes": ([_I] * 3, ctypes.c_size_t),
        "trr_window_mhsa_bwd_smem_bytes": ([_I] * 3, ctypes.c_size_t),
        "trr_rect_mhsa_fwd": ([_P] * 3 + [_I] * 8 + [_F, _P], _I),
        "trr_rect_mhsa_bwd": ([_P] * 6 + [_I] * 8 + [_F, _P], _I),
        "trr_rect_mhsa_smem_bytes": ([_I] * 4, ctypes.c_size_t),
        "trr_rect_mhsa_bwd_smem_bytes": ([_I] * 4, ctypes.c_size_t),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
build_report: dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_dir() -> Path:
    h = hashlib.sha256()
    nvcc = _nvcc()
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(set(SOURCES.values()) | set(HEADERS)):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, in parallel; return
    their paths. Records the seconds taken and nvcc's ptxas report in
    `build_report`. Raises with the compiler's output if a build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"libtrr_{name}.so" for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        )
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed)
        )
    build_report.update(
        seconds=time.perf_counter() - t0, built=todo, dir=str(out_dir), logs=logs
    )
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} (cudaError_t)")
