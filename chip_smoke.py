#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: SwinIR-M 4x, HAT-M 4x,
DAT 4x and Swin2SR-M 4x serving and training.

    python3 chip_smoke.py [--seed N]     # one card

Phases, all run, each printing its lines and ending the run with exit 1 on
failure:

1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
             versions; no card is a failure.
2. build   - compile the CUDA kernels from `trainner_redux_tpu_torch/csrc`.
3. kernels - each serving kernel against its plain PyTorch version at
             SwinIR-M shapes (B=1, 128x128 LR, C=180, 6 heads, ws 8), as the
             path calls them: K=1 unshifted and K=4 with the shift of 4 that
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
7. train kernels - the training block's forward (#4: out, P, att, z) and
             saved-P backward (#5: dx and 13 parameter gradients) against
             their plain versions at the SwinIR-M training block (B=8, 64x64
             LR, DropPath scales holding 0 and 1/0.9), K=1 unshifted and K=4
             shifted by 4; times and the card's bound.
8. train   - `trainner_redux_tpu_torch.train.run` on SwinIR-M 4x at full
             width and depth: 16 seeded 512x512 HR images, batch 8 of 64x64
             LR crops, L1, AdamW 2e-4, EMA 0.999, fp32, 30 steps and a
             checkpoint, counting launches; the EMA checkpoint then serves
             through `test.run` with the strict load.
9. train branches - one forward and backward from equal weights and batch
             through the kernel branch and the plain branch; losses and
             gradients must agree.
10. train profile - device time by kernel of one training step.
11. hat kernels - HAT-M's kernels at its training block (B=8, 64x64 LR,
             C=180, 6 heads, 16x16 windows, hidden 360): the ws-16 window
             forward (#3) and its backward (#8: dqkv, dbias; also at ws 8,
             SwinIR's unfused branch; two runs bit-identical), and the MLP
             half's backward (#7), each against its plain version; times,
             the card's bound and, for #3 and #8, SDPA with a float mask.
12. hat path - `test.run` on a seeded HAT-M 4x and the 4 images, counting
             launches (36 window-MHSA and 42 MLP kernels an image).
13. hat train - `train.run` on HAT-M 4x as phase 8 (30 steps), counting
             36 + 36 window-MHSA and 42 + 42 MLP launches a step.
14. hat train branches - one forward and backward of HAT-M, and one of
             SwinIR-M's unfused branch (TRAINNER_FUSED_BLOCK=0), each through
             the kernels and the plain branch; losses and gradients must agree.
15. hat train profile - device time by kernel of one HAT-M training step.
16. dat kernels - the rect forms of #3 and #8 (`fused_rect_mhsa` and its
             backward) at DAT's training block (B=8, the 48x48 LR crop's qkv
             padded to 64x64, a 90-channel branch of 3 heads of 30): windows
             8x32 and 32x8, K=1 and K=4 with their shifts, and dat_s's 8x16
             shifted; each against its plain version, two backward runs
             bit-identical; times, the card's bound and SDPA with a float
             mask.
17. dat path - `test.run` on a seeded DAT 4x and the 4 images, counting
             launches (36 rect-window forwards an image); one 128x128
             image's forward timed.
18. dat train - `train.run` on DAT 4x as `dat_fidelity.yml` has it (batch
             8 of 48x48 LR crops, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999) in
             fp32, 30 steps, counting 36 + 36 rect launches a step; the EMA
             checkpoint then serves with the strict load.
19. dat train branches - one forward and backward of DAT 4x (48x48 LR)
             through the kernels and the plain branch; losses and gradients
             must agree.
20. dat train profile - device time by kernel of one DAT training step.
21. swin2sr kernels - the post-norm SwinV2 halves at Swin2SR-M's training
             block (B=8, 48x48 LR, C=180, 6 heads of 30, ws 8, hidden 360,
             DropPath scales holding 0 and 1/0.9), K=1 and K=4 shifted by 4:
             the cosine-attention half (#11) and its backward (#12), the MLP
             half (#13) and its backward (#14), each against its plain
             version, two backward runs bit-identical; times and the card's
             bound; #11 and #13 also at B=1, 128x128 (serving).
22. swin2sr path - `test.run` on a seeded Swin2SR-M 4x and the 4 images,
             counting 36 #11 and 36 #13 launches an image; one 128x128
             forward timed through the kernel branch and the unfused branch
             (TRAINNER_FUSED_BLOCK=0), which must agree.
23. swin2sr train - `train.run` on Swin2SR-M 4x as `swin2sr_m_fidelity.yml`
             has it (batch 8 of 48x48 LR crops, L1 + MS-SSIM, AdamW 2e-4,
             EMA 0.999) in fp32, 30 steps, counting 36 launches of each of
             #11-#14 a step; the EMA checkpoint then serves with the strict
             load.
24. swin2sr train branches - one forward and backward of Swin2SR-M through
             the kernels and the unfused branch: losses and gradients
             (logit_scale and the CPB MLP included) must agree; then both
             timed.
25. swin2sr train profile - device time by kernel of one Swin2SR-M
             training step.

Then one JSON line of kernel records and, last, the device JSON line.
Scratch files go to `chiprun_out/chip_smoke/` under the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# SwinIR-M block shapes at B=1 and a 128x128 LR image (serving), and at the
# training batch: 8 crops of 64x64 LR (bench.py's SwinIR-M workload)
B, H, W, C, NH, WS, HIDDEN = 1, 128, 128, 180, 6, 8, 360
TB, TH, TW = 8, 64, 64
HD, N = C // NH, WS * WS
KERNEL_TOL = 1e-4  # unit-scale fp32 inputs; the kernels sum in another order
GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude
PATH_TOL = 1e-3  # [0, 1] outputs of 36 blocks, kernel vs plain branches
BRANCH_LOSS_TOL = 1e-4  # relative, one training loss, kernel vs plain branch
BRANCH_GRAD_TOL = 1e-3  # of each gradient tensor's largest, after 36 blocks back
N_IMAGES = 4
BLOCKS = 36
TRAIN_STEPS = 30
TRAIN_WARMUP = 5  # steps left out of the per-step median

# HAT-M's block: the same widths, 16x16 windows (n = 256), 42 MLP halves
HWS = 16
HN = HWS * HWS
HAT_BLOCKS = 36  # HABs: window attention
HAT_MLPS = 42  # HABs and OCABs: MLP halves

# DAT 4x: 18 spatial blocks of two rect-window branches, each a 90-channel
# half of 3 heads of 30; its training crop (dat_fidelity.yml) is 48x48 LR,
# whose qkv each spatial block pads to 64x64
DAT_RECT = 36  # rect-window attentions a forward
DC, DNH = 90, 3
DHD = DC // DNH
DAT_LQ = 48
# (h_sp, w_sp) -> the shift of a shifted block: dat's two orientations and
# dat_s's first
DAT_WINDOWS = {(8, 32): (4, 16), (32, 8): (16, 4), (8, 16): (4, 8)}

# Swin2SR-M 4x: 36 post-norm blocks at SwinIR-M's widths; its training crop
# (swin2sr_m_fidelity.yml) is 48x48 LR, with L1 + MS-SSIM
SWIN2SR_BLOCKS = 36
S2_LQ = 48
S2_LOSSES = ("l1loss", "mssimloss")

REPLACES = {
    "fused_attn_block": "trainner_redux_tpu/ops/pallas/fused_block.py:693",
    "fused_ln_mlp": "trainner_redux_tpu/ops/pallas/fused_block.py:388",
    "fused_window_mhsa": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_swin_block_train": "trainner_redux_tpu/ops/pallas/fused_block.py:1374",
    "fused_swin_block_train_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:1441",
    "fused_window_mhsa_ws16": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_ln_mlp_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
    "fused_rect_mhsa": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_rect_mhsa_backward": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_cos_attn_block": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:338",
    "fused_cos_attn_block_backward": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:373",
    "fused_postnorm_mlp": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:529",
    "fused_postnorm_mlp_backward": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:556",
}
SOURCES = {
    "fused_attn_block": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_ln_mlp": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_window_mhsa": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_swin_block_train": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_swin_block_train_backward": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_window_mhsa_ws16": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_ln_mlp_backward": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_rect_mhsa": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_rect_mhsa_backward": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_cos_attn_block": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_cos_attn_block_backward": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp_backward": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
}
# the kernel records of the JSON line; "fused_window_mhsa_ws16" is the
# window wrapper's 16x16 kernel, counted by that wrapper in HAT's runs
KERNELS = tuple(SOURCES)
SERVING = ("fused_attn_block", "fused_ln_mlp", "fused_window_mhsa")
# operands of the training block, in fused_swin_block_train's order
TRAIN_OPS = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2",
             "b2")


@contextmanager
def fused_env(env: dict):
    """TRAINNER_FUSED_BLOCK and TRAINNER_FUSED_ATTN as `env` sets them (unset
    otherwise) for the body, restored after."""
    saved = {k: os.environ.pop(k, None) for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN")}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def say(msg: str) -> None:
    """Print a result line, and keep it in chip_smoke/summary.txt (the
    entry points' own logs fill the console around it)."""
    print(msg, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "summary.txt", "a") as f:
        f.write(msg + "\n")


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


def block_inputs(gen, kinds: int, device, shape=(B, H, W)):
    """Seeded unit-scale inputs of one SwinIR-M block, at B=1, 128x128 unless
    `shape` gives (B, H, W)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    b, h, w = shape
    x = randn(b, h, w, C)
    p = {
        "g": 1.0 + randn(C, scale=0.1), "be": randn(C, scale=0.1),
        "wq": randn(C, 3 * C, scale=C**-0.5), "bq": randn(3 * C, scale=0.1),
        "wp": randn(C, C, scale=C**-0.5), "bp": randn(C, scale=0.1),
        "w1": randn(C, HIDDEN, scale=C**-0.5), "b1": randn(HIDDEN, scale=0.1),
        "w2": randn(HIDDEN, C, scale=HIDDEN**-0.5), "b2": randn(C, scale=0.1),
        "s": torch.ones(b, device=device),
    }
    rel = randn(NH, N, N, scale=0.5)
    if kinds == 4:
        masks = torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(device)
        bias = (rel[None] + masks[:, None]).contiguous()
    else:
        bias = rel[None].contiguous()
    qkv = randn(b, h, w, 3 * C)
    p["g2"], p["be2"] = 1.0 + randn(C, scale=0.1), randn(C, scale=0.1)
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


def _wrappers() -> dict:
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2
    from trainner_redux_tpu_torch.ops import window_attention as wa

    return {
        "fused_attn_block": fb.fused_attn_block,
        "fused_ln_mlp": fb.fused_ln_mlp,
        "fused_window_mhsa": wa.fused_window_mhsa,
        "fused_swin_block_train": fb.fused_swin_block_train,
        "fused_swin_block_train_backward": fb.fused_swin_block_train_backward,
        "fused_window_mhsa_backward": wa.fused_window_mhsa_backward,
        "fused_ln_mlp_backward": fb.fused_ln_mlp_backward,
        "fused_rect_mhsa": wa.fused_rect_mhsa,
        "fused_rect_mhsa_backward": wa.fused_rect_mhsa_backward,
        "fused_cos_attn_block": v2.fused_cos_attn_block,
        "fused_cos_attn_block_backward": v2.fused_cos_attn_block_backward,
        "fused_postnorm_mlp": v2.fused_postnorm_mlp,
        "fused_postnorm_mlp_backward": v2.fused_postnorm_mlp_backward,
    }


def check_counts(what: str, counts: dict[str, int], want: dict[str, int]) -> None:
    """The wrappers in `want` launched that many times, every other none."""
    if {k: v for k, v in counts.items() if v or k in want} != want:
        fail(f"{what} launches {counts}, expected {want} and no others")


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def make_dataset(root: Path, seed: int,
                 sizes=((128, 128),) * 3 + ((100, 120),)) -> tuple[Path, Path]:
    """Seeded smooth HR images and their 4x4 box-average LR, as PNGs; one
    image for each LR (height, width) of `sizes`."""
    import numpy as np

    from trainner_redux_tpu_torch.utils.img_util import imwrite

    rng = np.random.default_rng(seed)
    hr_dir, lr_dir = root / "hr", root / "lr"
    hr_dir.mkdir(parents=True, exist_ok=True)
    lr_dir.mkdir(parents=True, exist_ok=True)
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


def smoke_options(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int,
                  network: str = "swinir_m"):
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    metric = {"crop_border": 4, "test_y_channel": True}
    raw = {
        "name": name,
        "scale": 4,
        "num_gpu": 1,
        "manual_seed": seed,
        "network_g": {"type": network},
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


def serve(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int, env: dict,
          network: str = "swinir_m") -> dict:
    """One run of the serving entry point with kernel counts read around it."""
    import math

    import torch

    from trainner_redux_tpu_torch import test as port_test

    opt = smoke_options(name, weights, hr_dir, lr_dir, seed, network)
    with fused_env(env):
        t0 = time.perf_counter()
        reset_counts()
        model = port_test.run(opt)
        torch.cuda.synchronize()
        counts = read_counts()
        secs = time.perf_counter() - t0
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


def check_serving_counts(what: str, c: dict[str, int]) -> None:
    want = BLOCKS * N_IMAGES
    check_counts(what, c, {"fused_attn_block": want, "fused_ln_mlp": want})


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
    check_serving_counts("fused path", c)
    want = BLOCKS * N_IMAGES
    unfused = serve("swinir_m_x4_unfused", weights, hr_dir, lr_dir, seed,
                    {"TRAINNER_FUSED_BLOCK": "0"})
    u = unfused["counts"]
    check_counts("unfused path", u, {"fused_window_mhsa": want})
    for k in ("psnr", "ssim"):
        d = abs(fused["metrics"][k] - unfused["metrics"][k])
        if d > 1e-3:
            fail(f"{k} differs by {d:.3g} between the fused and unfused paths")
    weights.unlink()  # 48 MB: chiprun_out/ comes back only under 64 MiB
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
        with fused_env(env), torch.inference_mode():
            outs[branch] = net(x)
            fwd_ms = time_ms(lambda: net(x), iters=5, warmup=1)
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


def device_events(prof) -> list:
    """The profile's device kernels and copies by name. The device-side
    spans of `record_function` ranges (`Optimizer.step#AdamW.step`) are left
    out: they lie over the kernels they enclose, and would count them twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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
    events = device_events(prof)
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
# 7. train kernels
# ---------------------------------------------------------------------------


def train_flops(tokens: int) -> tuple[float, float]:
    """Operations of one block's forward (#4) and saved-P backward (#5).
    Forward: qkv, S and P v, proj, fc1 and fc2. Backward: the MLP side
    recomputes fc1 and takes dw2, dh, dw1, dy2 (5 products of T x C x
    hidden); the attention side recomputes qkv and takes datt, dwp, dwq, dy
    (11 products of T x C x C) and dv, dP, dq, dk (4 of T x n x C)."""
    t = tokens
    fwd = 2 * t * C * 3 * C + 4 * t * N * C + 2 * t * C * C + 4 * t * C * HIDDEN
    bwd = 10 * t * C * HIDDEN + 22 * t * C * C + 8 * t * N * C
    return fwd, bwd


def phase_train_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    T = TB * TH * TW
    keep = 1.0 / 0.9  # DropPath at rate 0.1: a sample keeps 1/0.9 or drops to 0
    s1 = torch.full((TB,), keep, device=dev)
    s1[1] = 0.0
    s2 = torch.full((TB,), keep, device=dev)
    s2[4] = 0.0
    fwd_flops, bwd_flops = train_flops(T)
    res: dict[str, dict] = {}
    for kinds in (1, 4):
        shift = WS // 2 if kinds == 4 else 0
        x, p, bias, _ = block_inputs(gen, kinds, dev, shape=(TB, TH, TW))
        ops = [x if k == "x" else bias if k == "bias" else p[k] for k in TRAIN_OPS]
        meta = (NH, HD, WS, 1e-5, shift)
        saved = [t for k, t in zip(TRAIN_OPS, ops) if k != "bias"]
        dout = torch.randn(TB, TH, TW, C, generator=gen).to(dev)

        def fwd():
            return fb._swin_block_train_fwd_cuda(*ops, s1, s2, *meta)

        def fwd_plain():
            return fb.fused_swin_block_train_reference(*ops, s1, s2, *meta)

        try:
            got = fwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train K={kinds}: {e}")
        want = fwd_plain()
        errs = {name: (g - w).abs().max().item() for name, g, w in
                zip(("out", "P", "att", "z"), got, want)}
        fwd_err = max(errs.values())
        if not fwd_err <= KERNEL_TOL or not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"fused_swin_block_train K={kinds} disagrees with its plain version: {errs}")

        def bwd():
            return fb.fused_swin_block_train_backward(*saved, s1, s2, *want[1:], dout, kinds,
                                                      *meta)

        def bwd_plain():
            return fb.fused_swin_block_train_bwd_reference(*saved, s1, s2, *want[1:], dout,
                                                           kinds, *meta)

        try:
            grads = bwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train_backward K={kinds}: {e}")
        names = ("dx", "dg1", "dbe1", "dwq", "dbq", "dwp", "dbp", "dbias", "dg2", "dbe2", "dw1",
                 "db1", "dw2", "db2")
        bwd_err, worst = check_grads("fused_swin_block_train_backward", f"K={kinds}", grads,
                                     bwd_plain(), names)
        fwd_bytes = nbytes(*ops, s1, s2, *got)
        bwd_bytes = nbytes(*saved, s1, s2, *want[1:], dout, *grads)
        cases = {
            "fused_swin_block_train": (fwd, fwd_plain, fwd_err, fwd_flops, fwd_bytes, ""),
            "fused_swin_block_train_backward": (
                bwd, bwd_plain, bwd_err, bwd_flops, bwd_bytes,
                f", largest error {worst:.3g} of its tensor's max |g|"),
        }
        for name, (kern, plain_fn, err, flops, nb, note) in cases.items():
            ms, plain_ms = time_ms(kern, iters=10, warmup=2), time_ms(plain_fn, iters=5, warmup=1)
            bms, by = bound(flops, nb)
            say(f"[train kernels] {name} K={kinds} shift {shift}: max_abs_err {err:.3g}{note} "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library n/a "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
            rec = res.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the times reported in the JSON line are the shifted (K=4) calls'
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
    return res


# ---------------------------------------------------------------------------
# 8. train (and 13. hat train)
# ---------------------------------------------------------------------------


def train_options(name: str, hr_dir: Path, lr_dir: Path, seed: int, network: str = "swinir_m",
                  lq: int = TH, losses: tuple[str, ...] = ("l1loss",)):
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = {
        "name": name, "scale": 4, "num_gpu": 1, "manual_seed": seed,
        "compute_dtype": "float32",
        "network_g": {"type": network},
        "path": {},
        "datasets": {"train": {
            "name": "smoke_train", "type": "PairedImageDataset",
            "dataroot_gt": str(hr_dir), "dataroot_lq": str(lr_dir),
            "io_backend": {"type": "disk"}, "lq_size": lq, "batch_size_per_gpu": TB,
            "num_worker_per_gpu": 4,
        }},
        "train": {
            "total_iter": TRAIN_STEPS, "ema_decay": 0.999,
            "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
            "losses": [{"type": t, "loss_weight": 1.0} for t in losses],
        },
        "logger": {"print_freq": 10, "save_checkpoint_freq": 1000, "use_tb_logger": False},
    }
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def phase_train(seed: int, network: str = "swinir_m", label: str = "SwinIR-M",
                tag: str = "train", per_step: dict[str, int] | None = None,
                serve_want: dict[str, int] | None = None, lq: int = TH,
                losses: tuple[str, ...] = ("l1loss",)) -> dict[str, int]:
    """The training entry point on `network` (batch 8 of lq x lq LR crops,
    the pair `losses`); returns the launch counts of its run, which must be
    `per_step` times the steps."""
    import math
    import statistics

    import torch

    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.models.sr_model import SRModel

    per_step = per_step or {"fused_swin_block_train": BLOCKS,
                            "fused_swin_block_train_backward": BLOCKS}
    serve_want = serve_want or {"fused_attn_block": BLOCKS * N_IMAGES,
                                "fused_ln_mlp": BLOCKS * N_IMAGES}
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    opt = train_options(f"{network}_x4_train", hr_dir, lr_dir, seed, network, lq, losses)
    ends, totals = [], []
    original = SRModel.optimize_parameters

    def timed(self, current_iter):
        original(self, current_iter)
        totals.append(float(self.log_dict["l_g_total"]))  # waits for the step
        ends.append(time.perf_counter())

    SRModel.optimize_parameters = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_counts()
        model = port_train.run(opt)
        torch.cuda.synchronize()
        counts = read_counts()
        secs = time.perf_counter() - t0
    finally:
        SRModel.optimize_parameters = original
    peak = torch.cuda.max_memory_allocated()
    steps = len(ends)
    per = [b - a for a, b in zip(ends[TRAIN_WARMUP:], ends[TRAIN_WARMUP + 1:])]
    med = statistics.median(per)
    q = statistics.quantiles(per, n=4)
    say(f"[{tag}] {label} 4x, batch {TB} of {lq}x{lq} LR, {' + '.join(losses)}, {steps} "
        f"steps in {secs:.2f} s "
        f"(model build and data included): median {med * 1e3:.2f} ms per step "
        f"(quartiles {q[0] * 1e3:.2f} / {q[2] * 1e3:.2f} ms, steps {TRAIN_WARMUP + 1}-{steps}), "
        f"{TB / med:.2f} images/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"[{tag}] l_g_total per step: first {totals[0]:.5f}, last {totals[-1]:.5f}; "
        f"launches {counts}")
    if steps != TRAIN_STEPS or model.step != TRAIN_STEPS:
        fail(f"{tag} ran {steps} steps (model step {model.step}), expected {TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in totals):
        fail(f"a training loss is not finite: {totals}")
    check_counts(f"{tag} ({label})", counts, {k: v * TRAIN_STEPS for k, v in per_step.items()})
    ema = Path(opt.path.models) / f"net_g_ema_{TRAIN_STEPS}.safetensors"
    if not ema.exists():
        fail(f"no EMA checkpoint at {ema}")
    state = Path(opt.path.training_states) / f"{TRAIN_STEPS}.state"
    if not (state.exists() and Path(f"{state}.meta.json").exists()):
        fail(f"no training state at {state}")
    eval_hr, eval_lr = make_dataset(OUT / "data", seed)
    served = serve(f"{network}_x4_trained", ema, eval_hr, eval_lr, seed, {}, network)
    check_counts(f"serving the trained {label} checkpoint", served["counts"], serve_want)
    # checkpoints, states and the 512x512 PNGs: too large to bring back
    shutil.rmtree(opt.path.models)
    shutil.rmtree(opt.path.training_states)
    shutil.rmtree(OUT / "train_data")
    return counts


# ---------------------------------------------------------------------------
# 9. train branches
# ---------------------------------------------------------------------------


def train_branches(seed: int, network: str, label: str, kernel_env: dict,
                   expect: dict[str, int], tag: str, lq: int = TH,
                   zero_grad: tuple[str, ...] = ()) -> None:
    """One forward and backward of `network` in train mode (DropPath on, from
    equal generators) on batch 8 of lq x lq LR through the kernel branch
    (`kernel_env`) and the plain branch (TRAINNER_FUSED_ATTN=0); the kernel
    branch launches `expect`. Parameters named in `zero_grad` (a true
    gradient of 0) are held against their block's largest gradient."""
    import copy

    import torch

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    net = build_network({"type": network, "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    nets = {"kernel": net, "plain": copy.deepcopy(net)}
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(TB, 3, lq, lq, generator=gen).cuda()
    gt = torch.rand(TB, 3, 4 * lq, 4 * lq, generator=gen).cuda()
    losses, grads, counts = {}, {}, {}
    for branch, env in (("kernel", kernel_env), ("plain", {"TRAINNER_FUSED_ATTN": "0"})):
        m = nets[branch]
        m.set_dropout_generator(torch.Generator(device="cuda").manual_seed(seed))
        with fused_env(env), fp32_math():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_counts()
            loss = (m(x) - gt).abs().mean()
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts[branch] = read_counts()
        losses[branch] = loss.item()
        # a parameter the step does not reach (DAT's BatchNorm statistics in
        # train mode) has a zero gradient, as SRModel hands it to AdamW
        grads[branch] = {k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in m.named_parameters()}
        say(f"[{tag}] {label} {branch} {env or ''}: loss {losses[branch]:.6f}, forward and "
            f"backward {secs * 1e3:.1f} ms (first call), launches {counts[branch]}")
    check_counts(f"{label} kernel branch", counts["kernel"], expect)
    check_counts(f"{label} plain branch", counts["plain"], {})
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    if not rel <= BRANCH_LOSS_TOL:
        fail(f"{label}: training loss differs by {rel:.3g} (relative) between the branches")

    def block_of(name: str) -> str:
        """`layers.i.residual_group.blocks.j` of a block parameter, else the name."""
        head, sep, tail = name.partition(".blocks.")
        return head + sep + tail.split(".")[0] if sep else name

    block_max: dict[str, float] = {}
    for k, g in grads["plain"].items():
        block_max[block_of(k)] = max(block_max.get(block_of(k), 0.0), g.abs().max().item())
    worst = (0.0, "")
    for k, w in grads["plain"].items():
        g = grads["kernel"][k]
        ref = w.abs().max().item()
        if ref == 0 or k.endswith(zero_grad):  # a zero true gradient
            ref = block_max[block_of(k)]
        err = (g - w).abs().max().item()
        worst = max(worst, (err / ref, k))
        if not err <= BRANCH_GRAD_TOL * ref:
            fail(f"{label}: gradient of {k} differs by {err:.3g} between the branches "
                 f"(ref {ref:.3g})")
    say(f"[{tag}] {label}: loss rel diff {rel:.3g} (tol {BRANCH_LOSS_TOL}); largest gradient "
        f"diff {worst[0]:.3g} of its tensor's max, at {worst[1]} (tol {BRANCH_GRAD_TOL})")


def phase_train_branches(seed: int) -> None:
    train_branches(seed, "swinir_m", "SwinIR-M", {},
                   {"fused_swin_block_train": BLOCKS, "fused_swin_block_train_backward": BLOCKS},
                   "train branches")


# ---------------------------------------------------------------------------
# 10. train profile
# ---------------------------------------------------------------------------


def phase_train_profile(seed: int, network: str = "swinir_m", tag: str = "train profile",
                        file: str = "profile_train.txt", lq: int = TH,
                        losses: tuple[str, ...] = ("l1loss",)) -> None:
    """Device time by kernel of one training step of `network` (batch 8 of
    lq x lq), after two warm-up steps; the table goes to chip_smoke/`file`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.models import build_model

    opt = train_options(f"{network}_x4_profile", OUT, OUT, seed, network, lq, losses)
    model = build_model(opt, device="cuda")
    rng = np.random.default_rng(seed)
    batch = {"lq": rng.integers(0, 256, (TB, lq, lq, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (TB, 4 * lq, 4 * lq, 3), dtype=np.uint8)}
    for i in range(2):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
    torch.cuda.synchronize()
    model.feed_data(batch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.optimize_parameters(3)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = device_events(prof)
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        say(f"[{tag}] the profiler recorded no device time")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50)
    (OUT / file).write_text(table)
    say(f"[{tag}] device time per step {total / 1e3:.3f} ms over "
        f"{sum(e.count for e in events)} kernel launches; step wall time under the "
        f"profiler {wall * 1e3:.1f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        say(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# 11. hat kernels
# ---------------------------------------------------------------------------


def window_inputs(gen, kinds: int, ws: int, device):
    """Seeded unit-scale qkv, kind table and output gradient of one window
    attention at the training block (B=8, 64x64, C=180, 6 heads)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    n = ws * ws
    qkv = torch.randn(TB, TH, TW, 3 * C, generator=gen).to(device)
    rel = (torch.randn(NH, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        rel = rel[None] + torch.from_numpy(shift_mask_kinds(ws, ws // 2)).to(device)[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(TB, TH, TW, C, generator=gen).to(device)
    return qkv, rel.contiguous(), dout


def sdpa_windows(qkv, bias, wr: int, wc: int, kinds: int, nh: int = NH, hd: int = HD):
    """(q, k, v, mask) of the wr x wc windows as SDPA takes them:
    (B*nW, nh, n, hd) each, the per-window bias as a float mask
    (B*nW, nh, n, n)."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    b, h, w, _ = qkv.shape
    win = qkv.reshape(b, h // wr, wr, w // wc, wc, 3, nh, hd)
    win = win.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, nh, wr * wc, hd).contiguous()
    mask = bias[wa.window_kinds(h // wr, w // wc, kinds, qkv.device)].repeat(b, 1, 1, 1)
    return win[0], win[1], win[2], mask


def from_windows(t, b: int, h: int, w: int, wr: int, wc: int, nh: int = NH, hd: int = HD):
    """(B*nW, nh, n, hd) -> (B, H, W, nh*hd)."""
    t = t.reshape(b, h // wr, w // wc, nh, wr, wc, hd)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, nh * hd)


def check_grads(name: str, label: str, grads, plain, parts) -> tuple[float, float]:
    """Each gradient within GRAD_TOL of its plain version's largest
    magnitude; returns the largest error and the largest relative one."""
    err, worst = 0.0, 0.0
    for part, g, w in zip(parts, grads, plain):
        e, top = (g - w).abs().max().item(), w.abs().max().item()
        err, worst = max(err, e), max(worst, e / top)
        if g.shape != w.shape or not e <= GRAD_TOL * top:
            fail(f"{name} {label}: {part} differs by {e:.3g} (max |g| {top:.3g})")
    return err, worst


def record_kernel(res: dict, tag: str, name: str, label: str, kern, plain, lib, flops: float,
                  nb: float, err: float, note: str = "") -> None:
    """Time a checked kernel, its plain version and its library call, print
    them with the card's bound, and keep them in `res[name]` (the last call
    recorded under a name is the one the JSON line reports)."""
    ms = time_ms(kern, iters=10, warmup=2)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    lib_ms = time_ms(lib, iters=10, warmup=2) if lib is not None else None
    bms, by = bound(flops, nb)
    say(f"[{tag}] {name} {label}: max_abs_err {err:.3g}{note} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
        f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
    rec = res.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)


def window_attention_cases(tag: str, name: str, label: str, ops, inputs, wr: int, wc: int,
                           kinds: int, nh: int, hd: int) -> dict:
    """Run one window-attention wrapper pair on the card (`ops`: forward,
    its plain version, backward, its plain version; `inputs`: qkv, the kind
    table, the output gradient), check the forward and the SDPA yardstick
    within KERNEL_TOL of the plain forward, both gradients within GRAD_TOL
    of their largest and two backward runs bit-identical; return the timed
    cases, name -> (kernel, plain, library, operations, bytes, error, note)."""
    import torch
    import torch.nn.functional as F

    fwd, fwd_plain, bwd, bwd_plain = ops
    qkv, bias, dout = inputs
    b, h, w, _ = qkv.shape
    n, tokens = wr * wc, b * h * w
    q, k, v, mask = sdpa_windows(qkv, bias, wr, wc, kinds, nh, hd)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    gwin = dout.reshape(b, h // wr, wr, w // wc, wc, nh, hd)
    gwin = gwin.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, n, hd).contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), gwin)

    try:
        with torch.no_grad():
            got = fwd()
        grads = bwd()
        again = bwd()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"{name} {label}: {e}")
    want = fwd_plain()
    fwd_err = (got - want).abs().max().item()
    lib_err = (from_windows(lib_fwd(), b, h, w, wr, wc, nh, hd) - want).abs().max().item()
    if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
        fail(f"{name} {label} disagrees with its plain version: {fwd_err:.3g}")
    if lib_err > KERNEL_TOL:
        fail(f"{name} {label}: the SDPA yardstick differs by {lib_err:.3g}")
    bwd_err, worst = check_grads(f"{name}_backward", label, grads, bwd_plain(), ("dqkv", "dbias"))
    if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
        fail(f"{name}_backward {label}: two runs differ")
    say(f"[{tag}] {label}: forward max_abs_err {fwd_err:.3g}, backward {bwd_err:.3g} "
        f"({worst:.3g} of its tensor's max |g|), two backward runs bit-identical")
    c = nh * hd
    return {
        name: (fwd, fwd_plain, lib_fwd, 4 * tokens * n * c, nbytes(qkv, bias, got), fwd_err, ""),
        f"{name}_backward": (bwd, bwd_plain, lib_fwd_bwd, 10 * tokens * n * c,
                             nbytes(qkv, bias, dout, *grads), bwd_err,
                             f", largest error {worst:.3g} of its tensor's max |g|"),
    }


def phase_hat_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    T = TB * TH * TW
    res: dict[str, dict] = {}
    # the JSON line reports the last case of each name: ws 16, shifted (K=4)
    for ws, kinds in ((8, 4), (16, 1), (16, 4)):
        qkv, bias, dout = inputs = window_inputs(gen, kinds, ws, dev)
        ops = (lambda: wa.fused_window_mhsa(qkv, bias, NH, HD, ws),
               lambda: wa.fused_window_mhsa_reference(qkv, bias, NH, HD, ws),
               lambda: wa.fused_window_mhsa_backward(qkv, bias, dout, NH, HD, ws),
               lambda: wa.fused_window_mhsa_bwd_reference(qkv, bias, dout, NH, HD, ws))
        cases = window_attention_cases("hat kernels", "fused_window_mhsa", f"ws {ws} K={kinds}",
                                       ops, inputs, ws, ws, kinds, NH, HD)
        if ws == 8:
            continue  # SwinIR's unfused branch: checked here, timed at ws 16 only
        for name, (kern, plain, lib, flops, nb, err, note) in cases.items():
            name = "fused_window_mhsa_ws16" if name == "fused_window_mhsa" else name
            record_kernel(res, "hat kernels", name, f"K={kinds}", kern, plain, lib, flops, nb,
                          err, note)

    # the MLP half's backward (#7), DropPath scales holding 0 and 1/0.9
    x, p, _, _ = block_inputs(gen, 1, dev, shape=(TB, TH, TW))
    s = torch.full((TB,), 1.0 / 0.9, device=dev)
    s[3] = 0.0
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    dout = torch.randn(TB, TH, TW, C, generator=gen).to(dev)

    def mlp_bwd():
        return fb.fused_ln_mlp_backward(x, *params, s, dout, HWS)

    def mlp_bwd_plain():
        return fb.fused_ln_mlp_bwd_reference(x, *params, s, dout, HWS)

    def mlp_fwd():
        with torch.no_grad():
            return fb.fused_ln_mlp(x, *params, s, HWS)

    try:
        out = mlp_fwd()
        grads = mlp_bwd()
        again = mlp_bwd()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"fused_ln_mlp / fused_ln_mlp_backward at 16-row strips: {e}")
    # the forward (#2) at HAT's training block, as HAB and OCAB call it
    fwd_err = (out - fb.fused_ln_mlp_reference(x, *params, s, HWS)).abs().max().item()
    if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(out).all()):
        fail(f"fused_ln_mlp at 16-row strips disagrees with its plain version: {fwd_err:.3g}")
    say(f"[hat kernels] fused_ln_mlp at HAT-M's training block: max_abs_err {fwd_err:.3g} "
        f"(tol {KERNEL_TOL}) kernel {time_ms(mlp_fwd, iters=10, warmup=2):.4f} ms")
    err, worst = check_grads("fused_ln_mlp_backward", "at 16-row strips", grads, mlp_bwd_plain(),
                             ("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"))
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail("fused_ln_mlp_backward: two runs differ")
    record_kernel(res, "hat kernels", "fused_ln_mlp_backward", "K=1", mlp_bwd, mlp_bwd_plain,
                  None, 10 * T * C * HIDDEN, nbytes(x, *params, s, dout, *grads), err,
                  f", largest error {worst:.3g} of its tensor's max |g|, two runs bit-identical")
    return res


# ---------------------------------------------------------------------------
# 12. hat path
# ---------------------------------------------------------------------------


def hat_serving_counts() -> dict[str, int]:
    return {"fused_window_mhsa": HAT_BLOCKS * N_IMAGES, "fused_ln_mlp": HAT_MLPS * N_IMAGES}


def phase_hat_path(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "hat_m", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "hat_m_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve("hat_m_x4", weights, hr_dir, lr_dir, seed, {}, "hat_m")
    check_counts("HAT-M serving path", served["counts"], hat_serving_counts())
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    with torch.inference_mode():
        out = net(x)
        fwd_ms = time_ms(lambda: net(x), iters=10, warmup=2)
    if out.shape != (1, 3, 512, 512) or not torch.isfinite(out).all():
        fail(f"HAT-M forward: bad output {tuple(out.shape)}")
    say(f"[hat path] HAT-M 4x forward of one 128x128 image {fwd_ms:.3f} ms")


# ---------------------------------------------------------------------------
# 16. dat kernels
# ---------------------------------------------------------------------------


def rect_inputs(gen, window: tuple[int, int], kinds: int, device):
    """Seeded unit-scale qkv, kind table and output gradient of one DAT
    branch at the training block (B=8, qkv padded to 64x64, 3 heads of 30)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import rect_shift_mask_kinds

    n = window[0] * window[1]
    qkv = torch.randn(TB, TH, TW, 3 * DC, generator=gen).to(device)
    rel = (torch.randn(DNH, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        masks = rect_shift_mask_kinds(*window, *DAT_WINDOWS[window])
        rel = rel[None] + torch.from_numpy(masks).to(device)[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(TB, TH, TW, DC, generator=gen).to(device)
    return qkv, rel.contiguous(), dout


def phase_dat_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    res: dict[str, dict] = {}
    # the JSON line reports the last case: DAT's first branch of a shifted block
    for (wr, wc), kinds in (((32, 8), 1), ((32, 8), 4), ((8, 16), 4), ((8, 32), 1),
                            ((8, 32), 4)):
        qkv, bias, dout = inputs = rect_inputs(gen, (wr, wc), kinds, dev)
        ops = (lambda: wa.fused_rect_mhsa(qkv, bias, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_reference(qkv, bias, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_backward(qkv, bias, dout, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_bwd_reference(qkv, bias, dout, DNH, DHD, wr, wc))
        label = f"{wr}x{wc} K={kinds}"
        cases = window_attention_cases("dat kernels", "fused_rect_mhsa", label, ops, inputs,
                                       wr, wc, kinds, DNH, DHD)
        for name, (kern, plain, lib, flops, nb, err, note) in cases.items():
            record_kernel(res, "dat kernels", name, label, kern, plain, lib, flops, nb, err, note)
    return res


# ---------------------------------------------------------------------------
# 17. dat path
# ---------------------------------------------------------------------------


def dat_serving_counts() -> dict[str, int]:
    return {"fused_rect_mhsa": DAT_RECT * N_IMAGES}


def phase_dat_path(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "dat", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "dat_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve("dat_x4", weights, hr_dir, lr_dir, seed, {}, "dat")
    check_counts("DAT serving path", served["counts"], dat_serving_counts())
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    with torch.inference_mode():
        out = net(x)
        fwd_ms = time_ms(lambda: net(x), iters=10, warmup=2)
    if out.shape != (1, 3, 512, 512) or not torch.isfinite(out).all():
        fail(f"DAT forward: bad output {tuple(out.shape)}")
    say(f"[dat path] DAT 4x forward of one 128x128 image {fwd_ms:.3f} ms")


# ---------------------------------------------------------------------------
# 21. swin2sr kernels
# ---------------------------------------------------------------------------


def v2_flops(tokens: int) -> dict[str, float]:
    """Operations of the post-norm halves at 8x8 windows. #11: qkv, cos and
    P v, proj. #12 recomputes them and takes datt, dwp, dv, dP, dq^, dk^,
    dwq and dx (24 T C^2 + 12 T n C in all). #13: fc1 and fc2. #14
    recomputes both and takes dhg, dx, dw2 and dw1."""
    t = tokens
    return {
        "fused_cos_attn_block": 8 * t * C * C + 4 * t * N * C,
        "fused_cos_attn_block_backward": 24 * t * C * C + 12 * t * N * C,
        "fused_postnorm_mlp": 4 * t * C * HIDDEN,
        "fused_postnorm_mlp_backward": 12 * t * C * HIDDEN,
    }


def v2_inputs(gen, kinds: int, device, shape):
    """Seeded unit-scale operands of one Swin2SR-M block: `block_inputs`'
    weights, temperatures exp(min(logit, log 100)) between 1 and 100, and a
    kind table of 16 * sigmoid values (plus the shift masks at K=4)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    x, p, _, _ = block_inputs(gen, 1, device, shape)
    p["scale"] = torch.exp(torch.rand(NH, generator=gen) * 4.6).to(device)
    bias = (16.0 * torch.sigmoid(torch.randn(NH, N, N, generator=gen))).to(device)[None]
    if kinds == 4:
        bias = bias + torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(device)[:, None]
    return x, p, bias.contiguous()


def phase_swin2sr_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    res: dict[str, dict] = {}
    s = torch.full((TB,), 1.0 / 0.9, device=dev)  # DropPath at rate 0.1: keep or drop
    s[2] = 0.0
    flops = v2_flops(TB * S2_LQ * S2_LQ)
    cos_parts = ("dx", "dwq", "dbq", "dscale", "dwp", "dbp", "dg", "dbe", "dbias")
    mlp_parts = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")
    # the JSON line reports the last case of each name: shifted (K=4)
    for kinds in (1, 4):
        shift = WS // 2 if kinds == 4 else 0
        x, p, bias = v2_inputs(gen, kinds, dev, (TB, S2_LQ, S2_LQ))
        dout = torch.randn(x.shape, generator=gen).to(dev)
        cos = (x, p["wq"], p["bq"], p["scale"], p["wp"], p["bp"], p["g"], p["be"], bias)
        mlp = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["g2"], p["be2"])
        meta = (NH, HD, WS, 1e-5, shift)
        cases = (
            ("fused_cos_attn_block", cos_parts, cos,
             lambda: v2.fused_cos_attn_block(*cos, s, *meta),
             lambda: v2.fused_cos_attn_block_reference(*cos, s, *meta),
             lambda: v2.fused_cos_attn_block_backward(*cos, s, dout, *meta),
             lambda: v2.fused_cos_attn_block_bwd_reference(*cos, s, dout, *meta)),
            ("fused_postnorm_mlp", mlp_parts, mlp,
             lambda: v2.fused_postnorm_mlp(*mlp, s, WS),
             lambda: v2.fused_postnorm_mlp_reference(*mlp, s, WS),
             lambda: v2.fused_postnorm_mlp_backward(*mlp, s, dout, WS),
             lambda: v2.fused_postnorm_mlp_bwd_reference(*mlp, s, dout, WS)),
        )
        label = f"K={kinds} shift {shift}"
        for name, parts, operands, fwd, fwd_plain, bwd, bwd_plain in cases:
            try:
                got = fwd()
                grads = bwd()
                again = bwd()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{name} {label}: {e}")
            fwd_err = (got - fwd_plain()).abs().max().item()
            if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
                fail(f"{name} {label} disagrees with its plain version: {fwd_err:.3g}")
            bwd_err, worst = check_grads(f"{name}_backward", label, grads, bwd_plain(), parts)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                fail(f"{name}_backward {label}: two runs differ")
            record_kernel(res, "swin2sr kernels", name, label, fwd, fwd_plain, None, flops[name],
                          nbytes(*operands, s, got), fwd_err)
            record_kernel(res, "swin2sr kernels", f"{name}_backward", label, bwd, bwd_plain, None,
                          flops[f"{name}_backward"], nbytes(*operands, s, dout, *grads), bwd_err,
                          f", largest error {worst:.3g} of its tensor's max |g|, two runs "
                          "bit-identical")

    # the serving shapes: B=1, one 128x128 image, shifted
    x, p, bias = v2_inputs(gen, 4, dev, (B, H, W))
    s1 = torch.ones(B, device=dev)
    cos = (x, p["wq"], p["bq"], p["scale"], p["wp"], p["bp"], p["g"], p["be"], bias)
    mlp = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["g2"], p["be2"])
    flops = v2_flops(B * H * W)
    for name, operands, kern, plain in (
        ("fused_cos_attn_block", cos,
         lambda: v2.fused_cos_attn_block(*cos, s1, NH, HD, WS, shift=WS // 2),
         lambda: v2.fused_cos_attn_block_reference(*cos, s1, NH, HD, WS, shift=WS // 2)),
        ("fused_postnorm_mlp", mlp, lambda: v2.fused_postnorm_mlp(*mlp, s1, WS),
         lambda: v2.fused_postnorm_mlp_reference(*mlp, s1, WS)),
    ):
        got = kern()
        err = (got - plain()).abs().max().item()
        if not err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
            fail(f"{name} at B=1, 128x128 disagrees with its plain version: {err:.3g}")
        bms, by = bound(flops[name], nbytes(*operands, s1, got))
        say(f"[swin2sr kernels] {name} at B=1, 128x128 (serving) K=4: max_abs_err {err:.3g} "
            f"kernel {time_ms(kern):.4f} ms plain {time_ms(plain):.4f} ms "
            f"bound {bms:.4f} ms ({by}; {flops[name] / 1e9:.3f} GFLOP)")
    return res


# ---------------------------------------------------------------------------
# 22. swin2sr path
# ---------------------------------------------------------------------------


def swin2sr_serving_counts() -> dict[str, int]:
    return {"fused_cos_attn_block": SWIN2SR_BLOCKS * N_IMAGES,
            "fused_postnorm_mlp": SWIN2SR_BLOCKS * N_IMAGES}


def phase_swin2sr_path(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swin2sr_m", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "swin2sr_m_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve("swin2sr_m_x4", weights, hr_dir, lr_dir, seed, {}, "swin2sr_m")
    check_counts("Swin2SR-M serving path", served["counts"], swin2sr_serving_counts())
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    outs = {}
    for branch, env, want in (
        ("kernel", {}, {"fused_cos_attn_block": SWIN2SR_BLOCKS,
                        "fused_postnorm_mlp": SWIN2SR_BLOCKS}),
        ("unfused", {"TRAINNER_FUSED_BLOCK": "0"}, {}),
    ):
        with fused_env(env), torch.inference_mode():
            reset_counts()
            outs[branch] = net(x)
            check_counts(f"Swin2SR-M {branch} branch forward", read_counts(), want)
            fwd_ms = time_ms(lambda: net(x), iters=10, warmup=2)
        if outs[branch].shape != (1, 3, 512, 512) or not torch.isfinite(outs[branch]).all():
            fail(f"Swin2SR-M {branch} forward: bad output {tuple(outs[branch].shape)}")
        say(f"[swin2sr path] Swin2SR-M 4x {branch} branch {env or ''}: forward of one 128x128 "
            f"image {fwd_ms:.3f} ms")
    d = (outs["kernel"] - outs["unfused"]).abs().max().item()
    say(f"[swin2sr path] kernel vs unfused branch: max_abs_diff {d:.3g} (tol {PATH_TOL})")
    if d > PATH_TOL:
        fail(f"Swin2SR-M: the kernel and unfused branches differ by {d:.3g}")


# ---------------------------------------------------------------------------
# 24. swin2sr train branches
# ---------------------------------------------------------------------------


def phase_swin2sr_train_branches(seed: int, per_step: dict[str, int]) -> None:
    """The kernel branch against the unfused one for one training forward
    and backward (the check), then both timed from equal weights."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    train_branches(seed, "swin2sr_m", "Swin2SR-M", {}, per_step, "swin2sr train branches", S2_LQ)
    net = build_network({"type": "swin2sr_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    net.set_dropout_generator(torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(TB, 3, S2_LQ, S2_LQ, generator=gen).cuda()
    gt = torch.rand(TB, 3, 4 * S2_LQ, 4 * S2_LQ, generator=gen).cuda()

    def step():
        net.zero_grad(set_to_none=True)
        (net(x) - gt).abs().mean().backward()

    for branch, env in (("kernel", {}), ("unfused", {"TRAINNER_FUSED_BLOCK": "0"})):
        with fused_env(env), fp32_math():
            ms = time_ms(step, iters=5, warmup=2)
        say(f"[swin2sr train branches] Swin2SR-M {branch} branch {env or ''}: forward and "
            f"backward of batch {TB} of {S2_LQ}x{S2_LQ} {ms:.2f} ms")


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    (OUT / "summary.txt").unlink(missing_ok=True)
    info = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_path(args.seed)
    phase_branches(args.seed)
    phase_profile(args.seed)
    kernels.update(phase_train_kernels())
    train_counts = phase_train(args.seed)
    launches.update({k: train_counts[k] for k in ("fused_swin_block_train",
                                                  "fused_swin_block_train_backward")})
    phase_train_branches(args.seed)
    phase_train_profile(args.seed)
    kernels.update(phase_hat_kernels())
    phase_hat_path(args.seed)
    hat_step = {"fused_window_mhsa": HAT_BLOCKS, "fused_window_mhsa_backward": HAT_BLOCKS,
                "fused_ln_mlp": HAT_MLPS, "fused_ln_mlp_backward": HAT_MLPS}
    hat_counts = phase_train(args.seed, "hat_m", "HAT-M", "hat train", hat_step,
                             hat_serving_counts())
    launches.update(fused_window_mhsa_ws16=hat_counts["fused_window_mhsa"],
                    fused_window_mhsa_backward=hat_counts["fused_window_mhsa_backward"],
                    fused_ln_mlp_backward=hat_counts["fused_ln_mlp_backward"])
    train_branches(args.seed, "hat_m", "HAT-M", {}, hat_step, "hat train branches")
    train_branches(args.seed, "swinir_m", "SwinIR-M unfused", {"TRAINNER_FUSED_BLOCK": "0"},
                   {"fused_window_mhsa": BLOCKS, "fused_window_mhsa_backward": BLOCKS},
                   "hat train branches")
    phase_train_profile(args.seed, "hat_m", "hat train profile", "profile_hat_train.txt")
    kernels.update(phase_dat_kernels())
    phase_dat_path(args.seed)
    dat_step = {"fused_rect_mhsa": DAT_RECT, "fused_rect_mhsa_backward": DAT_RECT}
    dat_losses = ("l1loss", "mssimloss")
    dat_counts = phase_train(args.seed, "dat", "DAT", "dat train", dat_step,
                             dat_serving_counts(), DAT_LQ, dat_losses)
    launches.update({k: dat_counts[k] for k in dat_step})
    from trainner_redux_tpu_torch.archs.dat_arch import ZERO_GRAD_PARAMS

    train_branches(args.seed, "dat", "DAT", {}, dat_step, "dat train branches", DAT_LQ,
                   ZERO_GRAD_PARAMS)
    phase_train_profile(args.seed, "dat", "dat train profile", "profile_dat_train.txt", DAT_LQ,
                        dat_losses)
    kernels.update(phase_swin2sr_kernels())
    phase_swin2sr_path(args.seed)
    s2_step = {k: SWIN2SR_BLOCKS for k in ("fused_cos_attn_block", "fused_cos_attn_block_backward",
                                           "fused_postnorm_mlp", "fused_postnorm_mlp_backward")}
    s2_counts = phase_train(args.seed, "swin2sr_m", "Swin2SR-M", "swin2sr train", s2_step,
                            swin2sr_serving_counts(), S2_LQ, S2_LOSSES)
    launches.update({k: s2_counts[k] for k in s2_step})
    phase_swin2sr_train_branches(args.seed, s2_step)
    phase_train_profile(args.seed, "swin2sr_m", "swin2sr train profile",
                        "profile_swin2sr_train.txt", S2_LQ, S2_LOSSES)

    records = []
    for name in KERNELS:
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
