#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: SwinIR-M 4x serving.

    python3 chip_smoke.py [--seed N]     # one card

Phases, all run, each printing its lines and ending the run with exit 1 on
failure:

1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
             versions; no card is a failure.
2. build   - compile the CUDA kernels from `trainner_redux_tpu_torch/csrc`.
3. kernels - each kernel against its plain PyTorch version at SwinIR-M
             shapes (B=1, 128x128 LR, C=180, 6 heads, ws 8), as the path
             calls them: K=1 unshifted and K=4 with the shift of 4 that
             fused_attn_block indexes itself; kernel, plain and library
             times and the card's bound.
4. path    - `trainner_redux_tpu_torch.test.run` on a seeded SwinIR-M 4x
             (.pth) and 4 seeded images (three 128x128 LR, one 100x120),
             counting kernel launches; then the same through the unfused
             branch (TRAINNER_FUSED_BLOCK=0), which runs fused_window_mhsa.
5. branches - one 128x128 image through the fused, unfused and plain
             (TRAINNER_FUSED_ATTN=0) branches, each timed; the outputs
             must agree.
6. profile - device time by kernel of the fused-branch forward.

Then one JSON line of kernel records and, last, the device JSON line.
Scratch files go to `chiprun_out/chip_smoke/` under the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# SwinIR-M block shapes at B=1 and a 128x128 LR image
B, H, W, C, NH, WS, HIDDEN = 1, 128, 128, 180, 6, 8, 360
HD, N = C // NH, WS * WS
KERNEL_TOL = 1e-4  # unit-scale fp32 inputs; the kernels sum in another order
PATH_TOL = 1e-3  # [0, 1] outputs of 36 blocks, kernel vs plain branches
N_IMAGES = 4
BLOCKS = 36

REPLACES = {
    "fused_attn_block": "trainner_redux_tpu/ops/pallas/fused_block.py:693",
    "fused_ln_mlp": "trainner_redux_tpu/ops/pallas/fused_block.py:388",
    "fused_window_mhsa": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
}
SOURCES = {
    "fused_attn_block": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_ln_mlp": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_window_mhsa": "trainner_redux_tpu_torch/csrc/window_attention.cu",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{info['kind']} x{info['count']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return info


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from trainner_redux_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    try:
        cuda_build.build_all()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"kernel build: {e}")
    rep = cuda_build.build_report
    say(f"[build] {time.perf_counter() - t0:.1f} s, built {rep['built']} in {rep['dir']}")
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "ptxas.txt", "w") as f:
        for name, log in rep["logs"].items():
            f.write(f"== {name}\n{log}\n")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def block_inputs(gen, kinds: int, device):
    """Seeded unit-scale inputs of one SwinIR-M block at B=1, 128x128."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    x = randn(B, H, W, C)
    p = {
        "g": 1.0 + randn(C, scale=0.1), "be": randn(C, scale=0.1),
        "wq": randn(C, 3 * C, scale=C**-0.5), "bq": randn(3 * C, scale=0.1),
        "wp": randn(C, C, scale=C**-0.5), "bp": randn(C, scale=0.1),
        "w1": randn(C, HIDDEN, scale=C**-0.5), "b1": randn(HIDDEN, scale=0.1),
        "w2": randn(HIDDEN, C, scale=HIDDEN**-0.5), "b2": randn(C, scale=0.1),
        "s": torch.ones(B, device=device),
    }
    rel = randn(NH, N, N, scale=0.5)
    if kinds == 4:
        masks = torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(device)
        bias = (rel[None] + masks[:, None]).contiguous()
    else:
        bias = rel[None].contiguous()
    qkv = randn(B, H, W, 3 * C)
    return x, p, bias, qkv


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    T = B * H * W
    res: dict[str, dict] = {}
    for kinds in (1, 4):
        x, p, bias, qkv = block_inputs(gen, kinds, dev)
        # SwinBlock passes the K=4 table together with the shift of ws/2
        shift = WS // 2 if kinds == 4 else 0
        cases = {
            "fused_attn_block": (
                lambda: fb.fused_attn_block(x, p["g"], p["be"], p["wq"], p["bq"], p["wp"],
                                            p["bp"], bias, p["s"], NH, HD, WS, shift=shift),
                lambda: fb.fused_attn_block_reference(x, p["g"], p["be"], p["wq"], p["bq"],
                                                      p["wp"], p["bp"], bias, p["s"], NH, HD,
                                                      WS, shift=shift),
                None,
                2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C,
                nbytes(x, x, p["g"], p["be"], p["wq"], p["bq"], p["wp"], p["bp"], bias, p["s"]),
            ),
            "fused_ln_mlp": (
                lambda: fb.fused_ln_mlp(x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"],
                                        p["s"], WS),
                lambda: fb.fused_ln_mlp_reference(x, p["g"], p["be"], p["w1"], p["b1"],
                                                  p["w2"], p["b2"], p["s"], WS),
                None,
                4 * T * C * HIDDEN,
                nbytes(x, x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"], p["s"]),
            ),
        }
        # the library yardstick: one SDPA call on windows already partitioned
        # into (B*nW, nh, n, hd), with the per-window bias as a float mask
        nw = (H // WS) * (W // WS)
        win = qkv.reshape(B, H // WS, WS, W // WS, WS, 3, NH, HD)
        win = win.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nw, NH, N, HD).contiguous()
        mask = bias[wa.window_kinds(H // WS, W // WS, kinds, dev)].repeat(B, 1, 1, 1)
        cases["fused_window_mhsa"] = (
            lambda: wa.fused_window_mhsa(qkv, bias, NH, HD, WS),
            lambda: wa.fused_window_mhsa_reference(qkv, bias, NH, HD, WS),
            lambda: F.scaled_dot_product_attention(win[0], win[1], win[2], attn_mask=mask),
            4 * T * N * C,
            nbytes(qkv, bias) + T * C * 4,
        )
        for name, (kern, plain, lib, flops, nb) in cases.items():
            try:
                got = kern()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{name} K={kinds}: {e}")
            want = plain()
            err = (got - want).abs().max().item()
            if lib is not None:
                lib_out = lib()  # (B*nW, nh, n, hd) -> NHWC, to check the yardstick
                lib_out = lib_out.reshape(B, H // WS, W // WS, NH, WS, WS, HD)
                lib_out = lib_out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, C)
                lib_err = (lib_out - want).abs().max().item()
                if lib_err > KERNEL_TOL:
                    fail(f"{name} K={kinds}: the SDPA yardstick differs by {lib_err:.3g}")
            ok = bool(err <= KERNEL_TOL) and bool(torch.isfinite(got).all())
            ms, plain_ms = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(lib) if lib is not None else None
            bms, by = bound(flops, nb)
            say(f"[kernels] {name} K={kinds}: max_abs_err {err:.3g} (tol {KERNEL_TOL}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
            if not ok:
                fail(f"{name} K={kinds} disagrees with its plain version: {err:.3g}")
            rec = res.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the times reported in the JSON line are the shifted (K=4) calls'
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
    return res


# ---------------------------------------------------------------------------
# 4. path
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    fb.fused_attn_block.launches = 0
    fb.fused_ln_mlp.launches = 0
    wa.fused_window_mhsa.launches = 0


def read_counts() -> dict[str, int]:
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    return {
        "fused_attn_block": fb.fused_attn_block.launches,
        "fused_ln_mlp": fb.fused_ln_mlp.launches,
        "fused_window_mhsa": wa.fused_window_mhsa.launches,
    }


def make_dataset(root: Path, seed: int) -> tuple[Path, Path]:
    """Seeded smooth HR images and their 4x4 box-average LR, as PNGs."""
    import numpy as np

    from trainner_redux_tpu_torch.utils.img_util import imwrite

    rng = np.random.default_rng(seed)
    hr_dir, lr_dir = root / "hr", root / "lr"
    hr_dir.mkdir(parents=True, exist_ok=True)
    lr_dir.mkdir(parents=True, exist_ok=True)
    sizes = [(128, 128)] * 3 + [(100, 120)]
    for i, (lh, lw) in enumerate(sizes):
        hh, hw = 4 * lh, 4 * lw
        yy, xx = np.mgrid[0:hh, 0:hw] / 64.0
        img = np.zeros((hh, hw, 3))
        for _ in range(6):
            fy, fx, ph = rng.uniform(0.2, 2.0), rng.uniform(0.2, 2.0), rng.uniform(0, 6.3)
            img += rng.uniform(0.05, 0.2, 3) * np.sin(fy * yy + fx * xx + ph)[..., None]
        img += 0.02 * rng.standard_normal(img.shape)
        hr = np.clip(img + 0.5, 0, 1)
        hr8 = (hr * 255).round().astype(np.uint8)
        lr = hr8.astype(np.float64).reshape(lh, 4, lw, 4, 3).mean(axis=(1, 3))
        imwrite(hr8, str(hr_dir / f"img{i}.png"))
        imwrite((lr / 255.0).astype(np.float32), str(lr_dir / f"img{i}.png"))
    return hr_dir, lr_dir


def smoke_options(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int):
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    metric = {"crop_border": 4, "test_y_channel": True}
    raw = {
        "name": name,
        "scale": 4,
        "num_gpu": 1,
        "manual_seed": seed,
        "network_g": {"type": "swinir_m"},
        "path": {"pretrain_network_g": str(weights), "strict_load_g": True},
        "datasets": {
            "test_1": {
                "name": "smoke", "type": "PairedImageDataset",
                "dataroot_gt": str(hr_dir), "dataroot_lq": str(lr_dir),
                "io_backend": {"type": "disk"},
            }
        },
        "val": {
            "val_enabled": True, "save_img": True, "pbar": False, "metrics_enabled": True,
            "metrics": {
                "psnr": {"type": "calculate_psnr", **metric},
                "ssim": {"type": "calculate_ssim", **metric},
            },
        },
    }
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=False)


def serve(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int, env: dict) -> dict:
    """One run of the serving entry point with kernel counts read around it."""
    import math

    import torch

    from trainner_redux_tpu_torch import test as port_test

    opt = smoke_options(name, weights, hr_dir, lr_dir, seed)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        reset_counts()
        model = port_test.run(opt)
        torch.cuda.synchronize()
        counts = read_counts()
        secs = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    pngs = sorted((Path(opt.path.visualization) / "smoke").glob("*.png"))
    metrics = getattr(model, "metric_results", {})
    say(f"[path] {name} {env or ''}: {secs:.2f} s, {len(pngs)} PNGs, "
        f"psnr {metrics.get('psnr', float('nan')):.4f} "
        f"ssim {metrics.get('ssim', float('nan')):.4f}, "
        f"launches {counts}")
    if len(pngs) != N_IMAGES:
        fail(f"{name}: {len(pngs)} PNGs written, expected {N_IMAGES}")
    if not all(math.isfinite(metrics.get(k, float("nan"))) for k in ("psnr", "ssim")):
        fail(f"{name}: PSNR/SSIM not logged or not finite: {metrics}")
    return {"counts": counts, "metrics": metrics}


def phase_path(seed: int) -> dict[str, int]:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    OUT.mkdir(parents=True, exist_ok=True)
    net = build_network({"type": "swinir_m", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "swinir_m_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)

    fused = serve("swinir_m_x4_fused", weights, hr_dir, lr_dir, seed, {})
    c = fused["counts"]
    want = BLOCKS * N_IMAGES
    if c["fused_attn_block"] != want or c["fused_ln_mlp"] != want or c["fused_window_mhsa"]:
        fail(f"fused path launches {c}, expected {want} + {want} block kernels and no "
             "window-MHSA")
    unfused = serve("swinir_m_x4_unfused", weights, hr_dir, lr_dir, seed,
                    {"TRAINNER_FUSED_BLOCK": "0"})
    u = unfused["counts"]
    if u["fused_window_mhsa"] != want or u["fused_attn_block"] or u["fused_ln_mlp"]:
        fail(f"unfused path launches {u}, expected {want} window-MHSA and no block kernels")
    for k in ("psnr", "ssim"):
        d = abs(fused["metrics"][k] - unfused["metrics"][k])
        if d > 1e-3:
            fail(f"{k} differs by {d:.3g} between the fused and unfused paths")
    return {**c, "fused_window_mhsa": u["fused_window_mhsa"]}


# ---------------------------------------------------------------------------
# 5. branches
# ---------------------------------------------------------------------------


def phase_branches(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swinir_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().eval()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    outs = {}
    for branch, env in (
        ("fused", {}), ("unfused", {"TRAINNER_FUSED_BLOCK": "0"}),
        ("plain", {"TRAINNER_FUSED_ATTN": "0"}),
    ):
        saved = {k: os.environ.get(k) for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN")}
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            with torch.inference_mode():
                outs[branch] = net(x)
                fwd_ms = time_ms(lambda: net(x), iters=5, warmup=1)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if outs[branch].shape != (1, 3, 512, 512) or not torch.isfinite(outs[branch]).all():
            fail(f"branch {branch}: bad output {tuple(outs[branch].shape)}")
        say(f"[branches] {branch}: SwinIR-M 4x forward of one 128x128 image {fwd_ms:.3f} ms")
    for branch in ("fused", "unfused"):
        d = (outs[branch] - outs["plain"]).abs().max().item()
        say(f"[branches] {branch} vs plain: max_abs_diff {d:.3g} (tol {PATH_TOL})")
        if d > PATH_TOL:
            fail(f"branch {branch} differs from the plain branch by {d:.3g}")


# ---------------------------------------------------------------------------
# 6. profile
# ---------------------------------------------------------------------------


def phase_profile(seed: int) -> None:
    """Device time by kernel over two fused-branch forwards of one 128x128
    image (torch.profiler, CUPTI); the table goes to chip_smoke/profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swinir_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().eval()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                net(x)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        say("[profile] the profiler recorded no device time")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    (OUT / "profile.txt").write_text(table)
    say(f"[profile] device time per forward {total / 2e3:.3f} ms over "
        f"{sum(e.count for e in events) // 2} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"[profile]   {e.self_device_time_total / 2e3:8.3f} ms  {e.count // 2:4d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    info = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_path(args.seed)
    phase_branches(args.seed)
    phase_profile(args.seed)

    records = []
    for name in ("fused_attn_block", "fused_ln_mlp", "fused_window_mhsa"):
        rec = kernels[name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
