"""The 128-wide #3 and #8 (the window MHSA forward and backward at heads of
65-128) of two trees on one CUDA card, in turns: each tree's kernels built
and timed in a process of its own, parent, this tree, this tree, parent.
Times are `chip_smoke.time_ms` (CUDA events over 20 back-to-back calls),
the least of 3, fp32 and bf16, at drct's training blocks (B=8, 48x48 LR,
16x16 windows): swin_3 (C 244, 2 heads of 122) K=1 and K=4, swin_5 (C 308,
4 heads of 77) K=4; beside them, in the same process, the 64-wide #3 and #8
at swin_2's block (C 212, 4 heads of 53, K=4), SDPA's forward at each
128-wide case and its forward and backward at swin_3 K=1
(`torch.nn.functional.scaled_dot_product_attention` with a float mask, the
library yardstick that the port never calls).

Run it from the root of this tree, naming the other tree's root (a `git
archive` of the parent commit unpacked into a directory .gitignore lists):

    python3 scripts/benchmarking/chip_wide_bwd_turns.py <parent tree>
"""

import subprocess
import sys

SNIPPET = r"""
import sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from trainner_redux_tpu_torch.ops import cuda_build, window_attention as wa
cuda_build.build_all()
gen = torch.Generator().manual_seed(24)
out = []
cases = (("swin_3 K=1", 244, 2, 1), ("swin_3 K=4", 244, 2, 4), ("swin_5 K=4", 308, 4, 4),
         ("64-wide swin_2 K=4", 212, 4, 4))


def best(fn):
    return min(cs.time_ms(fn, iters=20) for _ in range(3))


for label, c, nh, kinds in cases:
    qkv, bias, dout = cs.hd64_inputs(gen, kinds, (8, 48, 48), c, nh, 16)
    hd = c // nh
    for dtype in (None, torch.bfloat16):
        q, d = (qkv, dout) if dtype is None else (qkv.to(dtype), dout.to(dtype))
        name = 'bf16' if dtype else 'fp32'
        with torch.no_grad():
            t = best(lambda: wa.fused_window_mhsa(q, bias, nh, hd, 16))
        out.append(f"{label} {name} #3 {t:.4f} ms")
        t = best(lambda: wa.fused_window_mhsa_backward(q, bias, d, nh, hd, 16))
        out.append(f"{label} {name} #8 {t:.4f} ms")
        if label.startswith("64-wide"):
            continue
        qw, kw, vw, mask = cs.sdpa_windows(q, bias, 16, 16, kinds, nh, hd)
        if dtype is not None:
            mask = mask.to(dtype)
        with torch.no_grad():
            t = best(lambda: F.scaled_dot_product_attention(qw, kw, vw, attn_mask=mask))
        out.append(f"{label} {name} SDPA fwd {t:.4f} ms")
        if label == "swin_3 K=1":
            qg, kg, vg = (t_.clone().requires_grad_() for t_ in (qw, kw, vw))
            g = torch.randn_like(qw)

            def lib():
                o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
                return torch.autograd.grad(o, (qg, kg, vg), g)

            out.append(f"{label} {name} SDPA fwd+bwd {best(lib):.4f} ms")
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
