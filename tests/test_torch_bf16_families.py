"""bf16 training forwards of HAT, DAT and SwinIR-L on the port against the
JAX package, on the CPU (the port's kernel wrappers run their bf16 plain
versions; the JAX package runs its Pallas kernels in interpret mode in
bf16, TRAINNER_FUSED_BLOCK=interpret):

- a tiny HAT (embed 24, one group of two HABs and an OCAB, 2 heads of 12,
  window 8: the window attention on #3/#8's bf16 forms, every MLP half on
  #2/#7's), a tiny DAT (embed 48, two groups of two blocks, split (8, 16):
  the second group's first block shifted, the rect #3/#8's bf16 forms) and
  a 240-wide SwinIR-L (one group of two blocks, 8 heads of 30: the unfused
  branch, #3/#8's bf16 forms at 8x8), each 2x on a batch of 2 16x16 LR
  images, computing in bf16 in training against the flax network built
  with dtype=bfloat16, from equal parameters through `state_dict_from_jax`:
  the output within 2e-2 of its largest magnitude (as the bf16 SwinIR's,
  tests/test_torch_bf16_train.py); each parameter gradient held against
  the port's fp32 gradient, its error at most twice the flax bf16
  gradient's plus 1e-2 of the largest gradient of its block (a HAB, OCAB,
  DATB or SwinBlock; elsewhere of its own). The block's scale: DAT's
  interaction maps pass a few channels through a batch norm over 2 values
  each, which turns each bf16 rounding behind them into a large gradient
  error on their small tensors; XLA's CPU lowering keeps fp32 between the
  flax graph's ops there, the port rounds where the graph does. DAT's
  parameters whose true gradient is 0 (a bias before a train-mode norm, a
  constant of the position bias) carry only that rounding: each within
  2^-5 of the largest gradient of all (bf16 moves a real gradient 3-17%);
- what bf16 now builds where it was refused: a tiny SRFormerV2, a GAN
  model with DUnet, the OTF model and a tiny Swin2SR, each computing in
  bf16 on its bf16 kernel branch (the bf16 forms' calls counted on the
  CPU, where they run their plain versions: #1/#6 and #2/#7 for
  SRFormerV2's Swin blocks, #4/#5 for the tiny SwinIR of the GAN and OTF
  models, #11-#14 for Swin2SR's Swin2Blocks) and DUnet in bf16 (its
  features bf16, its logits fp32). Three
  bf16 `SRModel` steps of each family are in
  tests/test_torch_bf16_family_steps.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _config, _opts, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

OUT_TOL = 2e-2  # of the largest |output|
GRAD_RATIO, GRAD_SLACK = 2.0, 1e-2  # port's bf16 error <= RATIO x flax's + SLACK x block's largest
ZERO_TOL = 2.0**-5  # a true-zero gradient's noise, of the largest gradient of all
LR_SIDE, SCALE = 16, 2

NETS = {
    "HAT": {"type": "hat", "embed_dim": 24, "depths": [2], "num_heads": [2], "window_size": 8,
            "mlp_ratio": 2.0, "compress_ratio": 3, "squeeze_factor": 8, "num_feat": 16,
            "drop_path_rate": 0.0},
    "DAT": {"type": "dat", "embed_dim": 48, "depth": [2, 2], "num_heads": [4, 4],
            "split_size": [8, 16], "expansion_factor": 2.0, "drop_path_rate": 0.0},
    "SwinIR": {"type": "swinir_l", "embed_dim": 240, "depths": [2], "num_heads": [8],
               "drop_path_rate": 0.0},
}


def _jax_flat(net_opt: dict, scale: int = SCALE) -> dict:
    """The flax network's flattened parameters at `scale`, init plus noise."""
    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    net = build_network({**net_opt, "scale": scale})
    params = net.init(jax.random.key(0), jnp.zeros((1, LR_SIDE, LR_SIDE, 3)), train=False)
    rng = np.random.default_rng(1)
    return {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(params["params"]).items()}


def _block(name: str) -> str:
    """`layers.i[.residual_group].blocks.j` of a block parameter (its
    `overlap_attn` for HAT's OCAB), else the name."""
    for sep in (".blocks.", ".overlap_attn."):
        head, found, tail = name.partition(sep)
        if found:
            return head + sep + (tail.split(".")[0] if sep == ".blocks." else "")
    return name


@pytest.mark.parametrize("arch", list(NETS))
def test_bf16_family_matches_flax(arch, monkeypatch):
    from trainner_redux_tpu.archs import build_network_cast as jax_build_cast
    from trainner_redux_tpu.models.base_model import BaseModel
    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.archs.dat_arch import ZERO_GRAD_PARAMS
    from trainner_redux_tpu_torch.ops import fused_block as tfb
    from trainner_redux_tpu_torch.ops import window_attention as twa
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    net_opt = NETS[arch]
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    flat = _jax_flat(net_opt)
    jnet = jax_build_cast({**net_opt, "scale": SCALE}, jnp.bfloat16)
    rng = np.random.default_rng(4)
    lr = rng.random((2, LR_SIDE, LR_SIDE, 3)).astype(np.float32)
    side = SCALE * LR_SIDE
    wout = rng.standard_normal((2, side, side, 3)).astype(np.float32)

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(lr), train=True)
        return jnp.sum(out * wout), out

    params = BaseModel.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want_g = {k: np.asarray(v) for k, v in
              state_dict_from_jax(BaseModel.flatten_params(jgrads), arch).items()}

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    # the bf16 forms' wrappers: on the CPU their plain versions, uncounted
    wrappers = (twa.fused_window_mhsa_bf16, twa.fused_window_mhsa_backward_bf16,
                twa.fused_rect_mhsa_bf16, twa.fused_rect_mhsa_backward_bf16,
                tfb.fused_ln_mlp_bf16, tfb.fused_ln_mlp_backward_bf16)
    nets = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = build_network_cast({**net_opt, "scale": SCALE}, dtype)
        assert net.compute_dtype == dtype and net.bf16_refusal() is None
        net.load_state_dict(state_dict_from_jax(flat, arch), strict=False)
        net.train()
        calls = [f.launches for f in wrappers]
        out = net(torch.from_numpy(lr).permute(0, 3, 1, 2))
        assert out.dtype == torch.float32
        (out * torch.from_numpy(wout).permute(0, 3, 1, 2)).sum().backward()
        assert calls == [f.launches for f in wrappers]
        nets[dtype] = (out.detach().permute(0, 2, 3, 1).numpy(),
                       {k: p.grad.numpy() for k, p in net.named_parameters()
                        if p.grad is not None})
    got, got_g = nets[torch.bfloat16]
    want = np.asarray(want)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= OUT_TOL * top, f"output: max|diff| {err:.3g} vs max {top:.3g}"
    fp32_g = nets[torch.float32][1]
    assert got_g.keys() == fp32_g.keys()
    gmax = max(np.abs(g).max() for g in fp32_g.values())
    block_max: dict[str, float] = {}
    for k, g in fp32_g.items():
        block_max[_block(k)] = max(block_max.get(_block(k), 0.0), np.abs(g).max())
    for k, g in got_g.items():
        assert g.dtype == np.float32, k
        port, flax = np.abs(g - fp32_g[k]).max(), np.abs(want_g[k] - fp32_g[k]).max()
        if k.endswith(ZERO_GRAD_PARAMS):
            assert port <= ZERO_TOL * gmax, f"{k}: a true zero off by {port:.3g} of {gmax:.3g}"
            continue
        top = block_max[_block(k)]
        assert port <= GRAD_RATIO * flax + GRAD_SLACK * top, (
            f"{k}: bf16 off fp32 by {port:.3g} (flax bf16 {flax:.3g}) of its block's max|g| "
            f"{top:.3g}")


SWIN2SR_NET = {"type": "swin2sr_m", "embed_dim": 24, "depths": [2], "num_heads": [3],
               "num_feat": 16}
SRFORMER_NET = {"type": "srformerv2", "embed_dim": 32, "depths": [2], "num_heads": [2],
                "window_size": 12, "squeeze_dim": 8, "num_feat": 16}


SWIN2SR_FORMS = ("fused_cos_attn_block_bf16", "fused_cos_attn_block_backward_bf16",
                 "fused_postnorm_mlp_bf16", "fused_postnorm_mlp_backward_bf16")


def test_bf16_swin2sr_builds_on_its_bf16_kernel_branch(dataset, tmp_path,  # noqa: F811
                                                       monkeypatch):
    """The bf16 Swin2SR that was refused (#11-#14 had no bf16 forms): built
    from `compute_dtype: bfloat16`, its network computes in bf16 with no
    refusal, both Swin2Blocks on the bf16 forms of #11-#14, once each way."""
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.ops import fused_block_v2 as tv2

    _, opt = _opts(tmp_path, _config(dataset, compute_dtype="bfloat16", network_g=SWIN2SR_NET))
    model = build_model(opt, device="cpu")
    assert model.net_g.compute_dtype == torch.bfloat16 and model.net_g.bf16_refusal() is None
    counts = dict.fromkeys(SWIN2SR_FORMS, 0)
    for name in SWIN2SR_FORMS:
        def counted(*a, _real=getattr(tv2, name), _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tv2, name, counted)
    lq = torch.rand(1, 3, 24, 24, generator=torch.Generator().manual_seed(0))
    out = model.net_g.train()(lq)
    assert out.dtype == torch.float32
    out.mean().backward()
    assert counts == dict.fromkeys(SWIN2SR_FORMS, 2)


GAN = {"network_d": {"type": "dunet", "num_feat": 8},
       "train": {"total_iter": 1, "optim_g": {"type": "AdamW", "lr": 2e-4},
                 "losses": [{"type": "l1loss", "loss_weight": 1.0},
                            {"type": "ganloss", "gan_type": "vanilla", "loss_weight": 0.1}]}}
SWINIR_FORMS = ("fused_swin_block_train_bf16", "fused_swin_block_train_backward_bf16")
SRFORMER_FORMS = ("fused_attn_block_bf16", "fused_attn_block_backward_bf16",
                  "fused_ln_mlp_bf16", "fused_ln_mlp_backward_bf16")


@pytest.mark.parametrize(("extra", "model_type", "forms", "calls"), [
    ({"network_g": SRFORMER_NET}, "SRModel", SRFORMER_FORMS, 3),  # its three Swin blocks
    (GAN, "SRModel", SWINIR_FORMS, 4),  # the tiny SwinIR's four blocks
    ({**GAN, "high_order_degradation": True, "queue_size": 0}, "RealESRGANModel",
     SWINIR_FORMS, 4),
], ids=["srformerv2", "network_d", "otf"])
def test_bf16_builds_on_its_bf16_kernel_branch(dataset, tmp_path, monkeypatch, extra,  # noqa: F811
                                               model_type, forms, calls):
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.ops import fused_block as tfb

    cfg = _config(dataset, compute_dtype="bfloat16")
    cfg.update({k: v for k, v in extra.items() if k != "train"})
    cfg["train"].update(extra.get("train", {}))
    _, opt = _opts(tmp_path, cfg)
    model = build_model(opt, device="cpu")
    assert type(model).__name__ == model_type
    assert model.net_g.compute_dtype == torch.bfloat16
    counts = dict.fromkeys(forms, 0)
    for name in forms:
        def counted(*a, _real=getattr(tfb, name), _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tfb, name, counted)
    lq = torch.rand(1, 3, 24, 24, generator=torch.Generator().manual_seed(0))
    model.net_g.train()(lq).mean().backward()
    assert counts == dict.fromkeys(forms, calls)
    if model.net_d is not None:
        assert model.net_d.compute_dtype == torch.bfloat16
        logits, feats = model.net_d(torch.rand(1, 3, 32, 32), return_features=True)
        assert logits.dtype == torch.float32
        assert all(f.dtype == torch.bfloat16 for f in feats)
