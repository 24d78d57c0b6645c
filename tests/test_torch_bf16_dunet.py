"""DUnet in bf16 on the port against the JAX package, on the CPU: DUnet
(num_feat 16, train mode, a batch of 2 32x32 images) computing in bf16
against the flax DUnet built with dtype=bfloat16, from equal weights and
(u, v): the logits within 2e-2 of their largest magnitude (as the bf16
generators', tests/test_torch_bf16_families.py); the input gradient and
every parameter gradient held against the port's fp32 DUnet's (which
tests/test_torch_dunet.py holds to the JAX one at 1e-4) in L2: the port's
distance at most twice flax's plus 1e-2 of the fp32 gradient's norm
(`hold_to_fp32`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_bf16_gan import hold_to_fp32
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)
from trainner_redux_tpu.models.base_model import BaseModel as JBase
from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

OUT_TOL = 2e-2  # of the largest |logit|


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_bf16_dunet_matches_flax():
    from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
    from trainner_redux_tpu_torch.archs import build_network_cast

    opt = {"type": "dunet", "num_feat": 16}
    jnet = jax_build_cast(dict(opt), jnp.bfloat16)
    variables = jnet.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.05,
                          variables["params"])
    spectral = variables["spectral"]
    flat = {**JBase.flatten_params(params),
            **{f"__spectral__.{k}": v for k, v in JBase.flatten_params(spectral).items()}}
    x = rng.random((2, 32, 32, 3)).astype(np.float32)

    def f(p, xx):
        return jnet.apply({"params": p, "spectral": spectral}, xx, train=True)

    gy = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, xx, g):
        out, vjp = jax.vjp(f, p, xx)
        return out, vjp(g)

    want, (dparams, dx) = fwd_bwd(params, jnp.asarray(x), jnp.asarray(gy))
    assert want.dtype == jnp.float32 and want.shape == gy.shape
    flax_g = {k: np.asarray(v) for k, v in
              state_dict_from_jax(JBase.flatten_params(dparams), "DUnet").items()}
    flax_g["x"] = np.asarray(dx).transpose(0, 3, 1, 2)

    grads, outs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        net = build_network_cast(dict(opt), dtype)
        assert net.compute_dtype == dtype
        net.load_state_dict(state_dict_from_jax(flat, "DUnet"), strict=True)
        xt = _nchw(x).requires_grad_(True)
        out = net.train()(xt)
        assert out.dtype == torch.float32
        out.backward(_nchw(gy))
        outs[dtype] = out.detach().permute(0, 2, 3, 1).numpy()
        grads[dtype] = {"x": xt.grad.numpy(),
                        **{k: p.grad.numpy() for k, p in net.named_parameters()}}
    err, top = np.abs(outs[torch.bfloat16] - np.asarray(want)).max(), np.abs(want).max()
    assert err <= OUT_TOL * top, f"logits: max|diff| {err:.3g} vs max {top:.3g}"
    hold_to_fp32("DUnet", grads[torch.bfloat16], flax_g, grads[torch.float32])
