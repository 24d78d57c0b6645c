"""The training slice, torch port vs JAX package, on the CPU (the port's
kernel wrappers run their plain versions; the JAX package runs its Pallas
kernels in interpret mode, TRAINNER_FUSED_BLOCK=interpret).

- the train loader: with the same seed, options and epoch, uint8 batches
  bit-identical to the JAX package's;
- whole steps of a tiny SwinIR (embed 24, depths [2, 2], 3 heads, window
  8, scale 2, LR 16x16, batch 2, L1, AdamW, MultiStepLR with a milestone
  inside the run, EMA 0.999, fp32) from the same params and batches, with
  and without `accum_iter: 2`: step-1 gradients within 1e-4 of each
  tensor's largest; after 3 steps the logged loss, gradient norm and lr
  within 1e-5 relative each step, and params and EMA params within 1e-5,
  except entries whose step-1 gradient is below 1e-6 of the global
  largest (Adam turns rounding noise there into steps of +-lr; the key
  third of each qkv bias has a true gradient of 0);
- schedules and losses against the JAX functions;
- the entry point `train.run(opt, device="cpu")`: checkpoints, auto
  resume, and the JAX `SRModel.load_network` reading the port's weights;
- the repairs: train mode routes SwinBlock to `fused_swin_block_train`
  and eval to the serving kernels; DropPath draws from the model's
  generator only; unported options raise.
"""

import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

NET = {"type": "swinir_m", "embed_dim": 24, "depths": [2, 2], "num_heads": [3, 3],
       "drop_path_rate": 0}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """6 random 48x40 HR images and their 2x box-down LR."""
    root = tmp_path_factory.mktemp("train_ds")
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        hr = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
        lr = hr.reshape(24, 2, 20, 2, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        cv2.imwrite(str(root / "hr" / f"img{i}.png"), hr)
        cv2.imwrite(str(root / "lr" / f"img{i}.png"), lr)
    return root


def _config(dataset: Path, weights: Path | None = None, accum: int = 1, **extra) -> dict:
    cfg = {
        "name": "torch_train_parity", "scale": 2, "num_gpu": 1, "manual_seed": 5,
        "compute_dtype": "float32", "mesh": {"data": 1},
        "network_g": dict(NET),
        "path": {"pretrain_network_g": str(weights), "strict_load_g": True} if weights else {},
        "datasets": {"train": {
            "name": "tiny", "type": "PairedImageDataset",
            "dataroot_gt": str(dataset / "hr"), "dataroot_lq": str(dataset / "lr"),
            "lq_size": 16, "batch_size_per_gpu": 2, "accum_iter": accum,
            "num_worker_per_gpu": 2, "dataset_enlarge_ratio": 2,
        }},
        "train": {
            "total_iter": 3, "ema_decay": 0.999,
            # the lr of the repo's SwinIR-M workload (bench.py)
            "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "losses": [{"type": "l1loss", "loss_weight": 1.0}],
        },
        "logger": {"print_freq": 1, "save_checkpoint_freq": 1000, "use_tb_logger": False},
    }
    for k, v in extra.items():
        cfg[k] = v
    return cfg


def _yaml(tmp_path: Path, cfg: dict) -> str:
    path = tmp_path / "train.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _opts(tmp_path, cfg):
    """(JAX options, port options) parsed from one YAML file."""
    from trainner_redux_tpu.utils.options import parse_options as jax_parse
    from trainner_redux_tpu_torch.utils.options import parse_options

    argv = ["-opt", _yaml(tmp_path, cfg)]
    jopt, _ = jax_parse(str(tmp_path / "jax"), is_train=True, argv=argv)
    opt, _ = parse_options(str(tmp_path / "port"), is_train=True, argv=argv)
    return jopt, opt


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", [0, 3])
def test_train_loader_batches_match_jax(dataset, tmp_path, epoch):
    from trainner_redux_tpu.data import EnlargedSampler as JSampler
    from trainner_redux_tpu.data import build_dataloader as jbuild_loader
    from trainner_redux_tpu.data import build_dataset as jbuild_dataset
    from trainner_redux_tpu.utils.config import Config as JConfig
    from trainner_redux_tpu_torch.data import (
        EnlargedSampler,
        build_dataloader,
        build_dataset,
        resolve_enlarge_ratio,
    )

    jopt, opt = _opts(tmp_path, _config(dataset))
    JConfig.set_config(jopt)  # the JAX dataset reads its seed from here
    try:
        jds = jbuild_dataset(jopt.datasets["train"])
        jloader = jbuild_loader(jds, jopt.datasets["train"], num_gpu=1,
                                sampler=JSampler(len(jds), 1, 0, 2), seed=5)
        jloader.set_epoch(epoch)
        want = list(jloader)
    finally:
        JConfig.reset()
    ds = build_dataset(opt.datasets["train"], seed=opt.manual_seed)
    ratio = resolve_enlarge_ratio(opt.datasets["train"].dataset_enlarge_ratio, len(ds))
    loader = build_dataloader(ds, opt.datasets["train"], num_gpu=1,
                              sampler=EnlargedSampler(len(ds), 1, 0, ratio), seed=5)
    loader.set_epoch(epoch)
    got = list(loader)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in ("lq", "gt"):
            assert g[k].dtype == np.uint8 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        assert g["lq_path"] == w["lq_path"]


def test_device_prefetcher_is_one_batch_ahead(dataset, tmp_path):
    from trainner_redux_tpu_torch.data import DataLoader, DevicePrefetcher, build_dataset

    _, opt = _opts(tmp_path, _config(dataset))
    ds = build_dataset(opt.datasets["train"], seed=1)
    loader = DataLoader(ds, batch_size=2, num_workers=2, drop_last=True)
    pre = DevicePrefetcher(loader, "cpu")
    pre.reset()
    seen = []
    while (batch := pre.next()) is not None:
        assert isinstance(batch["lq"], torch.Tensor) and batch["lq"].dtype == torch.uint8
        seen.append(batch["lq"].numpy())
    assert len(seen) == 3
    np.testing.assert_array_equal(np.concatenate(seen), np.stack(
        [ds[i]["lq"] for i in range(6)]))
    pre.close()


# ---------------------------------------------------------------------------
# schedules, losses, optimizer defaults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", [
    None,
    {"type": "MultiStepLR", "milestones": [3, 7], "gamma": 0.5},
    {"type": "CosineAnnealingLR", "T_max": 9, "eta_min": 1e-6},
    {"type": "CosineAnnealingRestartLR", "periods": [4, 6], "restart_weights": [1, 0.5]},
    {"type": "CosineAnnealingWarmRestarts", "T_0": 3, "T_mult": 2},
    {"type": "StepLR", "step_size": 4, "gamma": 0.3},
    {"type": "LinearLR", "start_factor": 0.2, "total_iters": 6},
    {"type": "OneCycleLR", "max_lr": 1e-3, "total_steps": 12},
    {"type": "KneeLR", "peak_lr": 3e-4, "total_steps": 12, "warmup_steps": 2},
])
@pytest.mark.parametrize("warmup", [-1, 4])
def test_schedules_match_jax(sched, warmup):
    from trainner_redux_tpu.schedulers import build_scheduler as jbuild
    from trainner_redux_tpu.schedulers import with_warmup as jwarm
    from trainner_redux_tpu_torch.schedulers import build_scheduler, with_warmup

    want = jwarm(jbuild(sched, 2e-4, 12), warmup)
    got = with_warmup(build_scheduler(sched, 2e-4, 12), warmup)
    for step in range(14):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("loss", [
    {"type": "l1loss", "loss_weight": 0.7},
    {"type": "L1Loss", "reduction": "sum"},
    {"type": "charbonnierloss", "loss_weight": 2.0, "eps": 1e-6},
])
def test_losses_match_jax(loss):
    from trainner_redux_tpu.losses import build_loss as jbuild
    from trainner_redux_tpu.losses import loss_log_key as jkey
    from trainner_redux_tpu_torch.losses import build_loss, loss_log_key

    rng = np.random.default_rng(2)
    a, b = (rng.random((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    want = float(jbuild(loss)(jnp.asarray(a), jnp.asarray(b)))
    got = float(build_loss(loss)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert loss_log_key(build_loss(loss), loss["type"].lower()) == jkey(
        jbuild(loss), loss["type"].lower())


def test_unported_losses_and_optimizers_raise():
    from trainner_redux_tpu_torch.losses import build_loss
    from trainner_redux_tpu_torch.optimizers import build_optimizer

    with pytest.raises(NotImplementedError, match="distsloss"):
        build_loss({"type": "distsloss"})
    with pytest.raises(NotImplementedError, match="schedule"):
        build_loss({"type": "l1loss", "start_iter": 10})
    with pytest.raises(NotImplementedError, match="lion"):
        build_optimizer([torch.nn.Parameter(torch.ones(1))], {"type": "Lion"}, 10)


def test_adamw_takes_optax_defaults():
    """Left out of the config, weight decay is optax's 1e-4 (torch's AdamW
    would take 1e-2), eps 1e-8 and betas (0.9, 0.999)."""
    from trainner_redux_tpu_torch.optimizers import build_optimizer

    opt, _ = build_optimizer([torch.nn.Parameter(torch.ones(1))], {"type": "AdamW"}, 10)
    group = opt.param_groups[0]
    assert (group["weight_decay"], group["eps"], group["betas"]) == (1e-4, 1e-8, (0.9, 0.999))


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A JAX-framework safetensors of the tiny SwinIR, init plus noise."""
    from safetensors.numpy import save_file

    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    net = build_network({**NET, "scale": 2})
    params = net.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)["params"]
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in BaseModel.flatten_params(params).items()}
    path = tmp_path_factory.mktemp("weights") / "net_g.safetensors"
    save_file(flat, str(path), metadata={"framework": "trainner_redux_tpu", "arch": "swinir_m"})
    return path


def _to_port(flat: dict) -> dict[str, np.ndarray]:
    from trainner_redux_tpu_torch.utils.torch_compat import state_dict_from_jax

    return {k: np.asarray(v) for k, v in state_dict_from_jax(flat, "SwinIR").items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(dataset, jax_weights, tmp_path, monkeypatch, accum):
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JBase
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.setenv("TRAINNER_FUSED_BLOCK", "interpret")
    jopt, opt = _opts(tmp_path, _config(dataset, jax_weights, accum))
    jmodel = jbuild_model(jopt)
    model = build_model(opt, device="cpu")
    for k, v in model.net_g.state_dict().items():  # the same start
        np.testing.assert_array_equal(v.numpy(), _to_port(
            JBase.flatten_params(jmodel.state.params_g))[k], err_msg=k)

    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2 * accum, 16, 16, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2 * accum, 32, 32, 3), dtype=np.uint8)}
               for _ in range(3)]

    # step-1 gradients of the JAX loss, averaged over the micro-batches
    grad_fn = jax.grad(lambda p, lq, gt: jmodel._generator_losses(
        p, None, None, None, lq, gt, 0, jax.random.key(0))[0])
    jgrads = None
    for lq, gt in zip(np.split(batches[0]["lq"], accum), np.split(batches[0]["gt"], accum)):
        g = grad_fn(jmodel.state.params_g, jnp.asarray(lq, jnp.float32) / 255.0,
                    jnp.asarray(gt, jnp.float32) / 255.0)
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
    want_g = _to_port({k: v / accum for k, v in JBase.flatten_params(jgrads).items()})

    for i, batch in enumerate(batches, start=1):
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(i)
        jlog = jmodel.get_current_log()
        model.feed_data(batch)
        model.optimize_parameters(i)
        log = model.get_current_log()
        if i == 1:
            got_g = {k: p.grad.numpy() for k, p in model.net_g.named_parameters()}
            assert set(got_g) == set(want_g)
            for k, w in want_g.items():
                err = np.abs(got_g[k] - w).max()
                assert err <= 1e-4 * np.abs(w).max(), f"{k}: {err:.3g} vs {np.abs(w).max():.3g}"
        for key in ("l_g_l1", "l_g_total", "grad_norm_g"):
            np.testing.assert_allclose(log[key], jlog[key], rtol=1e-5, err_msg=f"{key} step {i}")
        np.testing.assert_allclose(model.get_current_learning_rate(),
                                   jmodel.get_current_learning_rate(), rtol=1e-5)
    assert model.get_current_learning_rate()[0] == pytest.approx(1e-4)  # after the milestone

    gmax = max(np.abs(w).max() for w in want_g.values())
    for name, net, jparams in (("params", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(JBase.flatten_params(jparams))
        for k, v in net.state_dict().items():
            live = np.abs(want_g[k]) >= 1e-6 * gmax
            err = np.abs(v.numpy() - want[k])[live]
            assert err.size == 0 or err.max() <= 1e-5, f"{name} {k}: {err.max():.3g}"


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_train_run_checkpoints_resume_and_jax_load(dataset, tmp_path, monkeypatch):
    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu.models.base_model import BaseModel as JBase
    from trainner_redux_tpu.utils.options import parse_options as jax_parse
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.utils.options import parse_options

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    cfg = _config(dataset)
    cfg["train"]["total_iter"] = 2
    cfg["logger"]["save_checkpoint_freq"] = 2
    yml = _yaml(tmp_path, cfg)
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", yml])
    model = port_train.run(opt, device="cpu", opt_file=yml)
    exp = tmp_path / "experiments" / cfg["name"]
    assert (exp / "models" / "net_g_ema_2.safetensors").exists()
    assert (exp / "models" / "resume_models" / "net_g_2.safetensors").exists()
    assert (exp / "training_states" / "2.state").exists()
    assert (exp / "training_states" / "2.state.meta.json").exists()
    assert (exp / "train.yml").exists() and model.step == 2

    # auto_resume continues from iteration 2 to 3
    cfg["train"]["total_iter"] = 3
    yml = _yaml(tmp_path, cfg)
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", yml, "--auto_resume"])
    resumed = port_train.run(opt, device="cpu")
    assert resumed.step == 3
    assert (exp / "training_states" / "3.state").exists()

    # the JAX package reads the port's checkpoint into equal params
    jcfg = {k: v for k, v in cfg.items() if k not in ("datasets", "train", "logger", "val")}
    jcfg["path"] = {"pretrain_network_g": str(exp / "models" / "net_g_ema_3.safetensors"),
                    "strict_load_g": True}
    jopt, _ = jax_parse(str(tmp_path / "jax"), is_train=False,
                        argv=["-opt", _yaml(tmp_path, jcfg)])
    got = _to_port(JBase.flatten_params(jbuild_model(jopt).state.params_g))
    for k, v in resumed.net_g_ema.state_dict().items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=0, err_msg=k)


def test_train_run_raises_without_card(dataset, tmp_path, monkeypatch):
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.utils.options import parse_options

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TRAINNER_PLATFORM", raising=False)
    opt, _ = parse_options(str(tmp_path), is_train=True,
                           argv=["-opt", _yaml(tmp_path, _config(dataset))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.run(opt)
    assert not (tmp_path / "experiments").exists()


@pytest.mark.parametrize(("extra", "match"), [
    ({"compute_dtype": "bfloat16"}, "bf16"),
    ({"use_amp": True}, "bf16"),
    ({"steps_per_dispatch": 2}, "steps_per_dispatch"),
    ({"network_d": {"type": "unetdiscriminatorsn"}}, "network_d"),
])
def test_unported_training_options_raise(dataset, tmp_path, extra, match):
    from trainner_redux_tpu_torch.models import build_model

    _, opt = _opts(tmp_path, _config(dataset, **extra))
    with pytest.raises(NotImplementedError, match=match):
        build_model(opt, device="cpu")


class _NanGrad(torch.autograd.Function):
    """Identity forward; a NaN gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def _flags():
    cudnn = torch.backends.cudnn
    return {"tf32": (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32),
            "deterministic": (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
                              cudnn.benchmark),
            "anomaly": torch.is_anomaly_enabled()}


@pytest.mark.parametrize("option", ["detect_anomaly", "fast_matmul", "deterministic",
                                    "use_compile", "use_channels_last",
                                    "find_unused_parameters"])
def test_training_options_are_honoured_or_noted(dataset, tmp_path, monkeypatch, capsys, option):
    """Each option the JAX entry acts on is honoured inside the training
    step (`train.run` on the CPU, one step) and restored after it:
    `detect_anomaly` raises on a NaN injected into the backward,
    `fast_matmul` lets cuBLAS and cuDNN take TF32 (off otherwise),
    `deterministic` runs the step on torch's deterministic algorithms with
    cuDNN's deterministic convolutions and sets cuBLAS's workspace. Each
    torch-only knob the port does not act on prints its NOTE line."""
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.models.sr_model import SRModel
    from trainner_redux_tpu_torch.utils.options import parse_options

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cfg = _config(dataset, use_channels_last=False, use_compile=False)
    cfg["train"]["total_iter"] = 1
    cfg[option] = True
    opt, _ = parse_options(str(tmp_path), is_train=True,
                           argv=["-opt", _yaml(tmp_path, cfg)])
    before = _flags()
    seen = []
    losses = SRModel._generator_losses

    def in_step(self, output, gt):
        seen.append(_flags())
        if option == "detect_anomaly":
            output = _NanGrad.apply(output)
        return losses(self, output, gt)

    monkeypatch.setattr(SRModel, "_generator_losses", in_step)
    if option == "detect_anomaly":
        with pytest.raises(RuntimeError, match="nan"):
            port_train.run(opt, device="cpu")
    else:
        port_train.run(opt, device="cpu")
    assert _flags() == before
    fast, det = option == "fast_matmul", option == "deterministic"
    assert seen[0] == {"tf32": (fast, fast), "deterministic": (True, True, False) if det
                       else before["deterministic"], "anomaly": option == "detect_anomaly"}
    assert (os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8") == det
    notes = [line for line in capsys.readouterr().out.splitlines() if line.startswith("NOTE:")]
    for knob in ("use_compile", "use_channels_last", "find_unused_parameters"):
        said = any(line.startswith(f"NOTE: {knob}") for line in notes)
        assert said == (knob == option or knob == "use_compile"), (knob, notes)


# ---------------------------------------------------------------------------
# routing and the DropPath generator
# ---------------------------------------------------------------------------


def test_train_mode_routes_to_the_train_block(monkeypatch):
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.archs import swinir_arch
    from trainner_redux_tpu_torch.ops import fused_block as fb

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    calls = {"train": 0, "attn": 0, "mlp": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(swinir_arch, "fused_swin_block_train",
                        counting("train", fb.fused_swin_block_train))
    monkeypatch.setattr(swinir_arch, "fused_attn_block", counting("attn", fb.fused_attn_block))
    monkeypatch.setattr(swinir_arch, "fused_ln_mlp", counting("mlp", fb.fused_ln_mlp))
    net = build_network({**NET, "scale": 2}).init_weights(torch.Generator().manual_seed(0))
    x = torch.rand(1, 3, 16, 16)
    net.train()
    net(x).mean().backward()
    assert calls == {"train": 4, "attn": 0, "mlp": 0}
    assert all(p.grad is not None for p in net.parameters())
    net.eval()
    with torch.no_grad():
        net(x)
    assert calls == {"train": 4, "attn": 4, "mlp": 4}


def test_train_mode_takes_the_unfused_branch_when_the_train_kernels_do_not_fit(monkeypatch):
    """A block too large for the training kernels (SwinIR-L's C 240, hidden
    480 on the card) trains on the unfused branch, through the window
    kernel's wrapper, instead of raising; eval keeps the serving kernels."""
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.archs import swinir_arch
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    assert not fb.swin_block_train_fits(64, 64, 8, 240, 8, 480)  # SwinIR-L
    calls = {"train": 0, "window": 0, "attn": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(swinir_arch, "swin_block_train_fits", lambda *a: False)
    monkeypatch.setattr(swinir_arch, "fused_swin_block_train",
                        counting("train", fb.fused_swin_block_train))
    monkeypatch.setattr(swinir_arch, "fused_window_mhsa", counting("window", wa.fused_window_mhsa))
    monkeypatch.setattr(swinir_arch, "fused_attn_block", counting("attn", fb.fused_attn_block))
    net = build_network({**NET, "scale": 2}).init_weights(torch.Generator().manual_seed(0))
    x = torch.rand(1, 3, 16, 16)
    net.train()
    net(x).mean().backward()
    assert calls == {"train": 0, "window": 4, "attn": 0}
    assert all(p.grad is not None for p in net.parameters())
    net.eval()
    with torch.no_grad():
        net(x)
    assert calls == {"train": 0, "window": 4, "attn": 4}


def test_droppath_draws_from_the_model_generator_only(dataset, tmp_path):
    from trainner_redux_tpu_torch.archs.fused_block_util import droppath_scale
    from trainner_redux_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="explicit torch.Generator"):
        droppath_scale(0.5, True, 4)
    assert torch.equal(droppath_scale(0.5, False, 4), torch.ones(4))

    cfg = _config(dataset)
    cfg["network_g"] = {**NET, "drop_path_rate": 0.5}
    masks = []
    for _ in range(2):
        _, opt = _opts(tmp_path, cfg)
        model = build_model(opt, device="cpu")
        block = model.net_g.layers[1].residual_group.blocks[1]
        assert block.generator is model.dropout_generator
        before = torch.random.get_rng_state()
        masks.append(torch.stack([droppath_scale(block.drop_path, True, 8, "cpu",
                                                 block.generator) for _ in range(3)]))
        model.feed_data({"lq": np.zeros((2, 16, 16, 3), np.uint8),
                         "gt": np.zeros((2, 32, 32, 3), np.uint8)})
        model.optimize_parameters(1)
        assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(masks[0], masks[1])
    assert set(masks[0].unique().tolist()) == {0.0, 2.0}


def test_train_cli_runs_on_the_cpu_when_asked(dataset, tmp_path):
    """`python -m trainner_redux_tpu_torch.train -opt x.yml` with
    TRAINNER_PLATFORM=cpu: one step, the config copied, the final save."""
    import os
    import subprocess
    import sys

    cfg = _config(dataset)
    cfg["train"]["total_iter"] = 1
    cfg["name"] = "debug_cli"
    yml = _yaml(tmp_path, cfg)
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "TRAINNER_PLATFORM": "cpu", "PYTHONPATH": str(repo)}
    out = subprocess.run([sys.executable, "-m", "trainner_redux_tpu_torch.train", "-opt", yml],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    exp = repo / "experiments" / "debug_cli"
    try:
        assert (exp / "models" / "net_g_ema_1.safetensors").exists()
        assert (exp / "train.yml").read_text().startswith("# GENERATE TIME")
    finally:
        import shutil

        shutil.rmtree(exp, ignore_errors=True)


def test_check_resume_points_at_the_resume_models(tmp_path):
    from trainner_redux_tpu_torch.utils.misc import check_resume
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    opt = decode({"name": "x", "scale": 2, "num_gpu": 1, "path": {},
                  "network_g": dict(NET)}, ReduxOptions)
    resolve_options(opt, str(tmp_path), is_train=True)
    Path(opt.path.resume_models).mkdir(parents=True)
    ckpt = Path(opt.path.resume_models) / "net_g_7.safetensors"
    ckpt.write_bytes(b"")
    check_resume(opt, 7)
    assert opt.path.pretrain_network_g is None  # no resume state: untouched
    opt.path.resume_state = str(tmp_path / "7.state")
    check_resume(opt, 7)
    assert opt.path.pretrain_network_g == str(ckpt)
