"""Post-training BatchNorm recalibration (port of the JAX package's
utils/bn_recalibrate.py).

Archs with `BatchNormNoStats` (DAT among the ported ones) keep their
running statistics as plain parameters: a converted checkpoint fills them,
but training from scratch leaves them at the identity (mean 0, var 1), so an
eval forward normalises with the wrong statistics. This pass refreshes them
deterministically: the network runs each calibration batch with every
BatchNormNoStats in train mode (batch statistics), each records its batch
mean and unbiased variance (as torch's running_var holds it), and the
averages over the batches replace the stored ones. A BatchNorm called k
times in one forward contributes the mean of its k calls.

The rest of the network runs in eval mode, so DropPath is off: the JAX
package applies the whole network in train mode, which needs a DropPath key
that its calibration does not give, so its calibration runs at
drop_path_rate 0, where the two agree.
"""

from __future__ import annotations

from collections.abc import Iterable

import torch


def recalibrate_bn(net: torch.nn.Module, batches: Iterable[torch.Tensor]) -> int:
    """Write the statistics of `batches` (NCHW inputs of `net`) into every
    BatchNormNoStats of `net`; returns the number of batches. Raises
    ValueError if `net` has no BatchNormNoStats or `batches` is empty."""
    from trainner_redux_tpu_torch.archs.dat_arch import BatchNormNoStats

    bns = [m for m in net.modules() if isinstance(m, BatchNormNoStats)]
    if not bns:
        raise ValueError("recalibrate_bn: the network has no BatchNormNoStats modules")
    calls: dict[torch.nn.Module, list] = {m: [] for m in bns}

    def record(module, inputs, _output):
        x = inputs[0]
        n = x.numel() // x.shape[1]
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False) * (n / max(n - 1, 1))
        calls[module].append((mean, var))

    handles = [m.register_forward_hook(record) for m in bns]
    was_training = net.training
    net.eval()
    for m in bns:
        m.train()
    sums: dict[torch.nn.Module, list[torch.Tensor]] = {}
    count = 0
    try:
        with torch.no_grad():
            for x in batches:
                for rec in calls.values():
                    rec.clear()
                net(x)
                for m, rec in calls.items():
                    stats = [torch.stack(s).mean(dim=0) for s in zip(*rec)]
                    sums[m] = stats if m not in sums else [a + b for a, b in zip(sums[m], stats)]
                count += 1
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    if count == 0:
        raise ValueError("recalibrate_bn: no calibration batches")
    with torch.no_grad():
        for m, (mean, var) in sums.items():
            m.running_mean.copy_(mean / count)
            m.running_var.copy_(var / count)
    return count
