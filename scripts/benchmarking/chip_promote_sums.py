"""How often the tensor-core engine's promoted products should add their
partial sums to the fp32 accumulator: accuracy against float64 and time,
on one CUDA card.

The engine (trainner_redux_tpu_torch/csrc/tc_gemm.cuh) sums `PROMOTE`
16-deep chunks of a promoted product in a wgmma accumulator before adding
them to an fp32 accumulator on the CUDA cores; the forwards run
kPromoteChunks (2). `cuda/promote_sums.cu` instantiates linear_kernel
(out = A W + b) at 1, 2 and 4 chunks and at never (one wgmma accumulator
over the whole depth). This script builds it and prints, for each setting
and each product of the pre-LN block forwards (qkv, fc1 and fc2 at
SwinIR-M's C 180 / hidden 360 on a 128x128 image, fc1 and fc2 at
SRFormerV2's C 240 / hidden 480 on 8 maps of 72x72), its time and its
largest error against float64, beside PyTorch's fp32 product (TF32 off).
A and W are unit-scale: A ~ N(0, 1), W ~ N(0, 1 / K), b ~ N(0, 1).

    python3 scripts/benchmarking/chip_promote_sums.py        # from the repo root

The library goes to chiprun_out/promote/; the settings run in turn, 1, 2,
4, never, then 1 and 2 again.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from trainner_redux_tpu_torch.ops import cuda_build  # noqa: E402

OUT = ROOT / "chiprun_out" / "promote"
ORDER = ((1, "1"), (2, "2"), (4, "4"), (0, "never"), (1, "1"), (2, "2"))
# name, tokens, K, N
PRODUCTS = (("qkv C 180", 16384, 180, 540), ("fc1 C 180", 16384, 180, 360),
            ("fc2 C 180", 16384, 360, 180), ("fc1 C 240", 41472, 240, 480),
            ("fc2 C 240", 41472, 480, 240))


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libpromote_sums.so"
    src = ROOT / "scripts" / "benchmarking" / "cuda" / "promote_sums.cu"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, stdout=subprocess.DEVNULL)
    dll = ctypes.CDLL(str(lib))
    dll.promote_linear.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dll.promote_linear.restype = ctypes.c_int
    return dll


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dll = build()
    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, t, k, n in PRODUCTS:
        a = torch.randn(t, k, generator=gen).cuda()
        w = (torch.randn(k, n, generator=gen) / k**0.5).cuda()
        b = torch.randn(n, generator=gen).cuda()
        exact = a.double() @ w.double() + b.double()
        torch_err = (a @ w + b - exact).abs().max().item()
        cases.append((name, a, w, b, exact, torch_err, torch.empty(t, n, device="cuda")))
    stream = torch.cuda.current_stream().cuda_stream
    for every, label in ORDER:
        parts = []
        for name, a, w, b, exact, torch_err, out in cases:
            def call():
                status = dll.promote_linear(every, a.data_ptr(), w.data_ptr(), b.data_ptr(),
                                            out.data_ptr(), a.shape[0], a.shape[1], w.shape[1],
                                            stream)
                if status:
                    raise RuntimeError(f"promote_linear: CUDA error {status}")
            ms = time_ms(call)
            err = (out.double() - exact).abs().max().item()
            parts.append(f"{name}: {ms:.4f} ms, float64 error {err:.3g} (PyTorch {torch_err:.3g})")
        print(f"[promote] every {label} chunks: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
