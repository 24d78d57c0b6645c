"""Host time of the pre-LN training block's forward wrapper (#4,
`ops/fused_block.py` `_swin_block_train_fwd_cuda`), and the OTF training
phase of `chip_smoke.py` alone, on one CUDA card.

Prints, at OTF's block (B=8, 32x32 LR, C 180, K=4) and at SwinIR-M's
training block (B=8, 64x64): the wrapper's host time a call (median and
quartiles of 200 calls, each after a synchronize, so its launches find an
idle queue; the checks, the scratch and output allocations and the
launches) beside its device time (CUDA events); then 30 steps of SwinIR-M 4x
OTF training (`chip_smoke.py`'s phase 28), with no other phase before it
in the process.

Run it from the root of the tree to measure; it imports that tree's
`chip_smoke.py` and package. To compare two trees on one card, run it in
each, in turns (parent, change, change, parent), in one chip call:

    python3 scripts/benchmarking/chip_host_cost.py
"""

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from trainner_redux_tpu_torch.ops import fused_block as fb  # noqa: E402

seed = 0
cs.phase_device()
cs.phase_build()
gen = torch.Generator().manual_seed(seed)
for lq in (32, 64):
    x, p, bias, _ = cs.block_inputs(gen, 4, torch.device("cuda"), (8, lq, lq))
    ops = [x if k == "x" else bias if k == "bias" else p[k] for k in cs.TRAIN_OPS]
    s = torch.full((8,), 1 / 0.9, device="cuda")

    def call():
        return fb._swin_block_train_fwd_cuda(*ops, s, s, 6, 30, 8, 1e-5, 4)

    host = []
    for i in range(220):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        if i >= 20:
            host.append((t1 - t0) * 1e6)
    torch.cuda.synchronize()
    q = statistics.quantiles(host, n=4)
    print(f"[host cost] #4 forward wrapper at B=8, {lq}x{lq}: host {q[1]:.1f} us a call "
          f"(quartiles {q[0]:.1f} / {q[2]:.1f}), device {cs.time_ms(call) * 1e3:.1f} us",
          flush=True)
hr_dir, _ = cs.make_dataset(cs.OUT / "otf_data", seed, ((128, 128),) * 16)
cs.phase_otf_train(seed, hr_dir)
print("host cost ok", flush=True)
