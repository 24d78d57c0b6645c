"""The serving slice end to end, torch port vs JAX package, on the CPU.

One YAML, one set of PNGs and one JAX-framework safetensors checkpoint (a
tiny SwinIR-S: embed 24, depths [2, 2], 3 heads, pixelshuffledirect 4x)
feed both packages:

- `SRModel.test` on the same LR image: outputs within 1e-4;
- `test_pipeline` (the `test.py` entry) of both: written PNGs within 1
  grey level, logged PSNR/SSIM within 1e-3.
"""

import importlib.util
import logging
import re
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
NET = {"type": "swinir_s", "embed_dim": 24, "depths": [2, 2], "num_heads": [3, 3]}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from safetensors.numpy import save_file

    from trainner_redux_tpu.archs import build_network
    from trainner_redux_tpu.models.base_model import BaseModel

    root = tmp_path_factory.mktemp("torch_sr")
    rng = np.random.default_rng(0)
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    for name, (h, w) in {"a": (16, 16), "b": (12, 20)}.items():
        lr = rng.random((h, w, 3))
        hr = np.repeat(np.repeat(lr, 4, 0), 4, 1) + 0.05 * rng.standard_normal((4 * h, 4 * w, 3))
        cv2.imwrite(str(root / "lr" / f"{name}.png"), (lr * 255).round().astype(np.uint8))
        cv2.imwrite(str(root / "hr" / f"{name}.png"),
                    (np.clip(hr, 0, 1) * 255).round().astype(np.uint8))

    net = build_network({**NET, "scale": 4})
    params = net.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)["params"]
    flat = {
        k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.05).astype(np.float32)
        for k, v in BaseModel.flatten_params(params).items()
    }
    weights = root / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "swinir_s"})

    yml = root / "test.yml"
    yml.write_text(f"""
name: torch_parity
scale: 4
num_gpu: 1
manual_seed: 0
mesh: {{data: 1}}
network_g: {{type: swinir_s, embed_dim: 24, depths: [2, 2], num_heads: [3, 3]}}
path:
  pretrain_network_g: {weights}
  strict_load_g: true
datasets:
  test_1:
    name: tiny
    type: PairedImageDataset
    dataroot_gt: {root / "hr"}
    dataroot_lq: {root / "lr"}
    io_backend: {{type: disk}}
val:
  val_enabled: true
  save_img: true
  pbar: false
  metrics_enabled: true
  metrics:
    psnr: {{type: calculate_psnr, crop_border: 4, test_y_channel: true}}
    ssim: {{type: calculate_ssim, crop_border: 4, test_y_channel: true}}
""")
    return root, yml


def test_sr_model_test_matches_jax(workspace, monkeypatch):
    from trainner_redux_tpu.models import build_model as jax_build_model
    from trainner_redux_tpu.utils.options import parse_options as jax_parse
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import parse_options

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    root, yml = workspace
    lq = np.random.default_rng(1).random((1, 20, 28, 3)).astype(np.float32)
    jopt, _ = jax_parse(str(root / "jax"), is_train=False, argv=["-opt", str(yml)])
    want = jax_build_model(jopt).test(lq)
    opt, _ = parse_options(str(root / "port"), is_train=False, argv=["-opt", str(yml)])
    got = build_model(opt, device="cpu").test(lq)
    assert got.shape == want.shape == (1, 80, 112, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _logged_metrics(records: list[str]) -> dict[str, float]:
    text = "\n".join(records)
    return {k: float(v) for k, v in re.findall(r"# (\w+): ([-0-9.]+)", text)}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_test_pipeline_matches_jax(workspace, monkeypatch):
    from trainner_redux_tpu_torch import test as port_test

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_PLATFORM", raising=False)
    root, yml = workspace
    spec = importlib.util.spec_from_file_location("jax_test_entry", REPO / "test.py")
    jax_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_test)

    cap = _Capture()
    jax_logger = logging.getLogger("trainner_redux_tpu")
    jax_logger.addHandler(cap)
    try:
        jax_test.test_pipeline(str(root / "jax_run"), ["-opt", str(yml)])
    finally:
        jax_logger.removeHandler(cap)
    want_metrics = _logged_metrics(cap.lines)

    model = port_test.test_pipeline(str(root / "port_run"), ["-opt", str(yml)], device="cpu")
    got_metrics = model.metric_results

    assert set(want_metrics) == set(got_metrics) == {"psnr", "ssim"}
    for k in want_metrics:
        assert abs(got_metrics[k] - want_metrics[k]) <= 1e-3, (k, got_metrics, want_metrics)

    vis = Path("results") / "torch_parity" / "visualization" / "tiny"
    want_pngs = sorted((root / "jax_run" / vis).glob("*.png"))
    got_pngs = sorted((root / "port_run" / vis).glob("*.png"))
    assert [p.name for p in got_pngs] == [p.name for p in want_pngs] == [
        "a_torch_parity.png", "b_torch_parity.png"
    ]
    for g, w in zip(got_pngs, want_pngs):
        a = cv2.imread(str(g)).astype(np.int16)
        b = cv2.imread(str(w)).astype(np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, g.name


def test_load_network_formats(workspace, tmp_path):
    """The port loads its three formats into equal weights: the JAX-framework
    safetensors, a torch-layout safetensors, and an upstream-style .pth with
    `params_ema` nesting, `module.` prefixes and recomputable buffers."""
    import torch
    from safetensors.torch import save_file

    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.utils.options import parse_options

    root, yml = workspace
    opt, _ = parse_options(str(tmp_path), is_train=False, argv=["-opt", str(yml)])
    model = build_model(opt, device="cpu")
    sd = {k: v.clone() for k, v in model.net_g.state_dict().items()}

    st = tmp_path / "torch_layout.safetensors"
    save_file(sd, str(st))
    pth = tmp_path / "upstream.pth"
    upstream = {f"module.{k}": v for k, v in sd.items()}
    upstream["module.layers.0.residual_group.blocks.0.attn.relative_position_index"] = (
        torch.zeros(64, 64, dtype=torch.long)
    )
    upstream["module.layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(4, 64, 64)
    torch.save({"params_ema": upstream}, pth)

    for path in (st, pth):
        for p in model.net_g.parameters():
            torch.nn.init.zeros_(p)
        model.load_network(model.net_g, str(path), strict=True)
        for k, v in model.net_g.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)

    bad = dict(sd)
    bad.pop("conv_first.weight")
    save_file(bad, str(st))
    with pytest.raises(ValueError, match="missing"):
        model.load_network(model.net_g, str(st), strict=True)
