"""The bf16 backwards #5, #6, #7, #12 and #14 and their weight-gradient
stage of two trees on one CUDA card, in turns: each tree's kernels built
and timed in a process of its own, parent, this tree, this tree, parent.
Times are device ms a call, `chip_smoke.graph_ms` (5 calls captured in a
CUDA graph, replayed 4 times between CUDA events: no host launch gaps,
which back-to-back calls take in on a loaded host), the least of 3, on
bf16 activations and fp32 parameters:

- #5 bf16 at SwinIR-M's training block (B 8, 64x64, C 180, 6 heads of 30,
  hidden 360), K=1 and K=4 shifted by 4, from its own forward's P, att, z;
- #6 bf16 at SRFormerV2's (B 16, 72x72, C 240, 8 heads of 30, 12x12
  windows), K=1 and K=4 shifted by 6;
- the weight-gradient stage alone (`fused_block_v2._weight_grad_bf16`) at
  each caller's (T, M, N), its bias sums from B itself, from an fp32 source
  or from another bf16 tensor as the caller sums them;
- #7 bf16 whole at HAT-M's MLP half (B 8, 64x64, C 180, hidden 360) and
  SRFormerV2's (B 16, 72x72, C 240, hidden 480); #12 and #14 bf16 whole at
  Swin2SR-M's block (B 8, 48x48, C 180, K=4 shifted by 4).

Run it from the root of this tree, naming the other tree's root (a `git
archive` of the parent commit unpacked into a directory .gitignore lists;
its `chip_smoke.py` and `trainner_redux_tpu_torch/` are all it needs):

    python3 scripts/benchmarking/chip_bf16_bwd_turns.py <parent tree>
"""

import subprocess
import sys

SNIPPET = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from trainner_redux_tpu_torch.ops import cuda_build, fused_block as fb, fused_block_v2 as v2
cuda_build.build_all()
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(26)
out = []


def best(fn):
    return min(cs.graph_ms(fn, iters=5, replays=4) for _ in range(3))


def rnd(*shape):
    return torch.randn(*shape, generator=gen).to(dev)


def scales(b):
    s = torch.full((b,), 1.0 / 0.9, device=dev)
    s[1] = 0.0
    return s


for kinds in (1, 4):  # #5 bf16 at SwinIR-M's block
    shift = 4 if kinds == 4 else 0
    x32, p, bias, _ = cs.block_inputs(gen, kinds, dev, shape=(8, 64, 64))
    ops = [x32.bfloat16() if k == "x" else bias if k == "bias" else p[k] for k in cs.TRAIN_OPS]
    s1, s2, meta = scales(8), scales(8), (6, 30, 8, 1e-5, shift)
    fwd = fb.fused_swin_block_train_bf16(*ops, s1, s2, *meta)
    saved = [t for k, t in zip(cs.TRAIN_OPS, ops) if k != "bias"]
    dout = rnd(8, 64, 64, 180).bfloat16()
    t = best(lambda: fb.fused_swin_block_train_backward_bf16(*saved, s1, s2, *fwd[1:], dout,
                                                             kinds, *meta))
    out.append(f"#5 bf16 K={kinds} {t:.4f} ms")
    del fwd, saved, ops
for kinds in (1, 4):  # #6 bf16 at SRFormerV2's block
    shift = 6 if kinds == 4 else 0
    x32, p, bias, _ = cs.block_inputs(gen, kinds, dev, (16, 72, 72), cs.SRF_WIDTHS)
    x, dout, s = x32.bfloat16(), rnd(16, 72, 72, 240).bfloat16(), scales(16)
    params = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp")]
    t = best(lambda: fb.fused_attn_block_backward_bf16(x, *params, bias, s, dout, 8, 30, 12, 1e-5,
                                                       shift))
    out.append(f"#6 bf16 K={kinds} {t:.4f} ms")
WG = (("#5 dw2", 32768, 360, 180, "bf16"), ("#5/#7 dw1", 32768, 180, 360, "fp32"),
      ("#5 dwp", 32768, 180, 180, "fp32"), ("#5 dwq", 32768, 180, 540, "b"),
      ("#6 dwp", 82944, 240, 240, "bf16"), ("#6 dwq", 82944, 240, 720, "b"),
      ("#7 C240 dw2", 82944, 480, 240, "bf16"), ("#7 C240 dw1", 82944, 240, 480, "fp32"),
      ("#12 dwq", 18432, 180, 540, "b"), ("#12 dwp", 18432, 180, 180, "fp32"),
      ("#14 dw2", 18432, 360, 180, "fp32"), ("#14 dw1", 18432, 180, 360, "fp32"))
for name, t_, m, n, src in WG:  # the weight-gradient stage alone
    a, s32 = rnd(t_, m).bfloat16(), rnd(t_, n)
    b = s32.bfloat16()
    kw = ({"sums_bf16": b} if src == "b" else {"sums_f32": s32} if src == "fp32"
          else {"sums_bf16": rnd(t_, n).bfloat16()})
    t = best(lambda: v2._weight_grad_bf16(a, b, **kw))
    out.append(f"wg {name} ({t_}, {m}, {n}) {t:.4f} ms")
    del a, s32, b, kw
for label, shape, c, hidden, ws in (("HAT-M", (8, 64, 64), 180, 360, 16),
                                     ("SRFormerV2", (16, 72, 72), 240, 480, 12)):  # #7 bf16
    x32, p, _, _ = cs.block_inputs(gen, 1, dev, shape, (c, c // 30, ws, hidden))
    x, dout, s = x32.bfloat16(), rnd(*shape, c).bfloat16(), scales(shape[0])
    params = [p[k] for k in ("g2", "be2", "w1", "b1", "w2", "b2")]
    t = best(lambda: fb.fused_ln_mlp_backward_bf16(x, *params, s, dout, ws))
    out.append(f"#7 bf16 {label} {t:.4f} ms")
x32, p, bias = cs.v2_inputs(gen, 4, dev, (8, 48, 48))  # #12 and #14 bf16 at Swin2SR-M's block
x, dout, s = x32.bfloat16(), rnd(8, 48, 48, 180).bfloat16(), scales(8)
cos = [p[k] for k in ("wq", "bq", "scale", "wp", "bp", "g", "be")]
t = best(lambda: v2.fused_cos_attn_block_backward_bf16(x, *cos, bias, s, dout, 6, 30, 8, 1e-5, 4))
out.append(f"#12 bf16 Swin2SR-M K=4 {t:.4f} ms")
mlp = [p[k] for k in ("w1", "b1", "w2", "b2", "g2", "be2")]
t = best(lambda: v2.fused_postnorm_mlp_backward_bf16(x, *mlp, s, dout, 8))
out.append(f"#14 bf16 Swin2SR-M {t:.4f} ms")
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
