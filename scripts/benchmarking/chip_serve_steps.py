"""One 128x128 LR image served by each family's 4x network on one CUDA card
(seeded weights, inference mode, fp32 with TF32 off, the default kernel
branch; SwinIR-M also its unfused branch, TRAINNER_FUSED_BLOCK=0): the
forward's device time (2 forwards captured in a CUDA graph, replayed 5
times between CUDA events; where the forward copies from the host and no
graph can hold it, Swin2SR's and SRFormerV2's, torch.profiler's device
kernels of one forward, the largest of 3 sessions) and its host-clock time
(CUDA events around eager calls: the median of 7 timed groups of 2
forwards after 3 warm-ups, with the least and largest group). The host
clock of a served forward varies between processes on a shared host; the
device time does not depend on it.

Run it from the root of a tree to measure; it imports that tree's package.
To compare two trees on one card, run it in turns (A, B, B, A) in one
session:

    cd <tree> && python3 /path/to/chip_serve_steps.py
"""

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from trainner_redux_tpu_torch.archs import build_network  # noqa: E402

# (network, environment of its branch)
SERVED = (("swinir_m", {}), ("swinir_m", {"TRAINNER_FUSED_BLOCK": "0"}), ("hat_m", {}),
          ("dat", {}), ("swin2sr_m", {}), ("srformerv2", {}))


def graph_ms(fn, iters: int = 2, replays: int = 5) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph,
    replayed `replays` times between CUDA events (no host in the way, and
    no profiler, which may drop some of a long session's launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def profiled_ms(fn, sessions: int = 3) -> float:
    """Device time of one call where a graph cannot capture it (a forward
    that copies from the host): the device kernels and copies of one call
    under torch.profiler, record_function spans left out; the largest of
    `sessions` sessions, as the profiler may drop launches but adds none."""
    from torch.profiler import ProfilerActivity, profile

    sums = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        sums.append(sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)) / 1e3)
    return max(sums)


def host_ms(fn, groups: int = 7, calls: int = 2, warmup: int = 3) -> list[float]:
    """Time a call by CUDA events: the per-call time of each timed group."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(0)).cuda()
    for network, env in SERVED:
        net = build_network({"type": network, "scale": 4})
        net = net.init_weights(torch.Generator().manual_seed(0)).cuda().eval()
        saved = {k: os.environ.pop(k, None) for k in ("TRAINNER_FUSED_BLOCK",)}
        os.environ.update(env)
        with torch.inference_mode():
            out = net(x)
            if out.shape != (1, 3, 512, 512) or not torch.isfinite(out).all():
                sys.exit(f"{network}: bad output {tuple(out.shape)}")
            times = host_ms(lambda: net(x))
            try:
                dev = f"{graph_ms(lambda: net(x)):.3f} ms a forward (CUDA graph)"
            except RuntimeError:  # the forward copies from the host: no graph
                torch.cuda.synchronize()
                dev = f"{profiled_ms(lambda: net(x)):.3f} ms a forward (profiler, largest of 3)"
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        print(f"[serve] {network} {env or ''}: device {dev}; host clock "
              f"{statistics.median(times):.3f} ms (median of 7 groups of 2; "
              f"{min(times):.3f}-{max(times):.3f})", flush=True)
        del net
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
