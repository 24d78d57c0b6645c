"""The forms a change to the window attention or the rows stage is to leave
alone, of two trees on one CUDA card, in turns: each tree's kernels built
and timed in a process of its own, parent, this tree, this tree, parent.
Times are `chip_smoke.time_ms` (CUDA events over 20 back-to-back calls),
the least of 3, fp32 and bf16:

- the 32-wide window attention (#3 and #8 at heads of 30, 16x16 windows,
  K=4 shifted) at HAT-M's training block (B=8, 64x64) and atd's (B=4,
  48x48);
- the 64-wide form (heads of 35, atd's C 210) at atd's block;
- #7 (the MLP half's backward) on its one-tile rows stage: the 192-column
  tile at C 180 / hidden 360 and the 256-column tile at C 240 / hidden 480
  (B=8, 48x48).

Run it from the root of this tree, naming the other tree's root (a `git
archive` of the parent commit unpacked into a directory .gitignore lists):

    python3 scripts/benchmarking/chip_window32_turns.py <parent tree>
"""

import subprocess
import sys

SNIPPET = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from trainner_redux_tpu_torch.ops import cuda_build, window_attention as wa
cuda_build.build_all()
gen = torch.Generator().manual_seed(2)
out = []
for dtype in (None, torch.bfloat16):
    for shape in ((8, 64, 64), (4, 48, 48)):
        qkv = torch.randn(*shape, 540, generator=gen).cuda()
        rel = (torch.randn(6, 256, 256, generator=gen) * 0.5).cuda()
        masks = torch.from_numpy(wa.shift_mask_kinds(16, 8)).cuda()
        bias = (rel[None] + masks[:, None]).contiguous()
        dout = torch.randn(*shape, 180, generator=gen).cuda()
        if dtype is not None:
            qkv, dout = qkv.to(dtype), dout.to(dtype)
        with torch.no_grad():
            f = min(cs.time_ms(lambda: wa.fused_window_mhsa(qkv, bias, 6, 30, 16), iters=20)
                    for _ in range(3))
        b = min(cs.time_ms(lambda: wa.fused_window_mhsa_backward(qkv, bias, dout, 6, 30, 16),
                           iters=20) for _ in range(3))
        out.append(f"{'bf16' if dtype else 'fp32'} B={shape[0]} {shape[1]}x{shape[2]}: "
                   f"#3 {f:.4f} ms, #8 {b:.4f} ms")
qkv = torch.randn(4, 48, 48, 630, generator=gen).cuda()
rel = (torch.randn(6, 256, 256, generator=gen) * 0.5).cuda()
bias = (rel[None] + torch.from_numpy(wa.shift_mask_kinds(16, 8)).cuda()[:, None]).contiguous()
dout = torch.randn(4, 48, 48, 210, generator=gen).cuda()
for dtype in (None, torch.bfloat16):
    q, d = (qkv, dout) if dtype is None else (qkv.to(dtype), dout.to(dtype))
    with torch.no_grad():
        f = min(cs.time_ms(lambda: wa.fused_window_mhsa(q, bias, 6, 35, 16), iters=20)
                for _ in range(3))
    b = min(cs.time_ms(lambda: wa.fused_window_mhsa_backward(q, bias, d, 6, 35, 16), iters=20)
            for _ in range(3))
    out.append(f"64-wide {'bf16' if dtype else 'fp32'}: #3 {f:.4f} ms, #8 {b:.4f} ms")
from trainner_redux_tpu_torch.ops import fused_block as fb
for c, hidden in ((180, 360), (240, 480)):
    x = torch.randn(8, 48, 48, c, generator=gen).cuda()
    p = [1.0 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen),
         torch.randn(c, hidden, generator=gen) * c**-0.5, 0.1 * torch.randn(hidden, generator=gen),
         torch.randn(hidden, c, generator=gen) * hidden**-0.5, 0.1 * torch.randn(c, generator=gen)]
    p = [t.cuda() for t in p]
    s = torch.ones(8).cuda()
    g = torch.randn(8, 48, 48, c, generator=gen).cuda()
    for dtype in (None, torch.bfloat16):
        xx, gg = (x, g) if dtype is None else (x.to(dtype), g.to(dtype))
        t = min(cs.time_ms(lambda: fb.fused_ln_mlp_backward(xx, *p, s, gg, 16), iters=20)
                for _ in range(3))
        out.append(f"#7 C {c} {'bf16' if dtype else 'fp32'}: {t:.4f} ms")
print(" | ".join(out), flush=True)
"""


def main() -> None:
    parent = sys.argv[1]
    for root in (parent, ".", ".", parent):
        r = subprocess.run([sys.executable, "-c", SNIPPET], cwd=root, capture_output=True,
                           text=True)
        tail = r.stderr.strip()[-300:] if r.returncode else ""
        print(f"[{root}] rc={r.returncode} {r.stdout.strip()} {tail}", flush=True)
        if r.returncode:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()
