"""#8 bf16 (the window-attention backward at heads of 30) and #1 bf16 (the
12x12 attention half's forward) of two trees on one CUDA card, in turns:
each tree's kernels built and timed in a process of its own, parent, this
tree, this tree, parent. Times are device ms a call, `chip_smoke.graph_ms`
(5 calls captured in a CUDA graph, replayed 4 times between CUDA events),
the least of 3, on bf16 activations and fp32 parameters and kind tables:

- #8 bf16 at HAT-M's block (B 8, 48x48, C 180, 6 heads of 30) with 16x16
  windows, K=1 and K=4 (the masks of a shift by 8); at DAT's 90-channel
  branch (B 8, 64x64, 3 heads of 30) with 8x32 and 32x8 windows, K=4; at
  dat_s's 8x16 (B 8, 48x48), K=4; at SwinIR-L's block (B 8, 48x48, C 240, 8
  heads of 30) with 8x8 windows, K=4;
- #1 bf16 at SRFormerV2's block as its template ships it (B 16, 72x72, C
  240, 8 heads of 30, 12x12 windows), K=1 and K=4 shifted by 6, with its
  stages: each kernel's device ms a call from `torch.profiler` over 5 calls;
- #6 bf16 at the same block, K=1, as a control.

Run it from the root of this tree, naming the other tree's root (a `git
archive` of the parent commit unpacked into a directory .gitignore lists;
its `chip_smoke.py` and `trainner_redux_tpu_torch/` are all it needs):

    python3 scripts/benchmarking/chip_bf16_window_turns.py <parent tree>
"""

import subprocess
import sys

SNIPPET = r"""
import sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from trainner_redux_tpu_torch.ops import cuda_build, fused_block as fb, window_attention as wa
cuda_build.build_all()
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(27)
out = []


def best(fn):
    return min(cs.graph_ms(fn, iters=5, replays=4) for _ in range(3))


def rnd(*shape):
    return torch.randn(*shape, generator=gen).to(dev)


WINDOWS = (("HAT-M ws 16 K=1", (16, 16), 1, (8, 48, 48), 180, 6),
           ("HAT-M ws 16 K=4", (16, 16), 4, (8, 48, 48), 180, 6),
           ("DAT 8x32 K=4", (8, 32), 4, (8, 64, 64), 90, 3),
           ("DAT 32x8 K=4", (32, 8), 4, (8, 64, 64), 90, 3),
           ("dat_s 8x16 K=4", (8, 16), 4, (8, 48, 48), 90, 3),
           ("SwinIR-L ws 8 C 240 K=4", (8, 8), 4, (8, 48, 48), 240, 8))
for label, (wr, wc), kinds, shape, c, nh in WINDOWS:  # #8 bf16
    n = wr * wc
    qkv, dout = rnd(*shape, 3 * c).bfloat16(), rnd(*shape, c).bfloat16()
    rel = (rnd(nh, n, n) * 0.5)[None]
    if kinds == 4:
        masks = torch.from_numpy(wa.rect_shift_mask_kinds(wr, wc, wr // 2, wc // 2)).to(dev)
        rel = rel + masks[:, None]
    bias = rel.contiguous()
    t = best(lambda: wa.fused_rect_mhsa_backward_bf16(qkv, bias, dout, nh, c // nh, wr, wc))
    out.append(f"#8 bf16 {label} {t:.4f} ms")
    del qkv, dout, bias


def stages(fn, calls=5):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    return ", ".join(f"{k.split('(')[0][:48]} {v:.4f}" for k, v in sorted(rows, key=lambda r: -r[1]))


s = torch.full((16,), 1.0 / 0.9, device=dev)
s[5] = 0.0
for kinds in (1, 4):  # #1 bf16 at SRFormerV2's block, and #6 bf16 at K=1
    shift = 6 if kinds == 4 else 0
    x32, p, bias, _ = cs.block_inputs(gen, kinds, dev, (16, 72, 72), cs.SRF_WIDTHS)
    x = x32.bfloat16()
    params = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp")]
    fwd = lambda: fb.fused_attn_block_bf16(x, *params, bias, s, 8, 30, 12, 1e-5, shift)
    out.append(f"#1 bf16 K={kinds} {best(fwd):.4f} ms [{stages(fwd)}]")
    if kinds == 1:
        dout = rnd(16, 72, 72, 240).bfloat16()
        t = best(lambda: fb.fused_attn_block_backward_bf16(x, *params, bias, s, dout, 8, 30, 12,
                                                           1e-5, shift))
        out.append(f"#6 bf16 K=1 {t:.4f} ms")
        del dout
    del x32, x, p, bias
print(" | ".join(out), flush=True)
"""


def main() -> None:
    parent = sys.argv[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in (parent, ".", ".", parent):
        r = subprocess.run([sys.executable, "-c", SNIPPET], cwd=root, capture_output=True,
                           text=True)
        tail = r.stderr.strip()[-300:] if r.returncode else ""
        print(f"[{root}] rc={r.returncode} {r.stdout.strip()} {tail}", flush=True)
        if r.returncode:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()
