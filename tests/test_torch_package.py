"""Package-level rules of the torch port, checked on the CPU.

- it imports no `jax`, `flax`, `optax` or `trainner_redux_tpu` module (nor
  does `chip_smoke.py`), and imports without cv2, yaml or safetensors;
- its entry points run on CUDA unless the CPU is asked for, and raise when
  there is no card;
- a kernel wrapper runs its plain version for a CPU tensor only, and never
  falls back for a tensor elsewhere;
- `chip_smoke.py` fails without a card and prints no result.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "trainner_redux_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "trainner_redux_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_imports_without_optional_host_packages():
    code = (
        "import sys\n"
        "for m in ('cv2', 'yaml', 'safetensors', 'tqdm', 'rich', 'jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import trainner_redux_tpu_torch.test, trainner_redux_tpu_torch.models.sr_model\n"
        "import trainner_redux_tpu_torch.data, trainner_redux_tpu_torch.metrics\n"
        "import trainner_redux_tpu_torch.utils.torch_compat\n"
        "import trainner_redux_tpu_torch.utils.options\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from trainner_redux_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TRAINNER_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("TRAINNER_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")


def test_test_run_raises_without_card(monkeypatch, tmp_path):
    from trainner_redux_tpu_torch import test as port_test
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TRAINNER_PLATFORM", raising=False)
    opt = decode({"name": "x", "scale": 4, "num_gpu": 1, "path": {},
                  "network_g": {"type": "swinir_s"}}, ReduxOptions)
    resolve_options(opt, str(tmp_path), is_train=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.run(opt)
    assert not (tmp_path / "results").exists()  # nothing ran


@pytest.mark.parametrize("preset", ["swinir_s", "swinir_m", "swinir_l"])
def test_swinir_test_templates_build(preset):
    """The repo's SwinIR test templates decode strictly and build in the port."""
    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.utils.options import yaml_load

    templates = REPO / "configs" / "_templates" / "test" / "SwinIR"
    opt, _ = yaml_load(str(templates / f"{preset}_test.yml"))
    net = build_network({**opt.network_g, "scale": opt.scale})
    assert net.upscale == opt.scale == 4
    assert sum(p.numel() for p in net.parameters()) > 0


def _attn_args(device):
    rng = np.random.default_rng(0)
    b, h, w, nh, hd, ws = 1, 8, 8, 2, 8, 8
    c = nh * hd

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    return (t(b, h, w, c), t(c), t(c), t(c, 3 * c), t(3 * c), t(c, c), t(c),
            t(1, nh, ws * ws, ws * ws), torch.ones(b, device=device), nh, hd, ws)


def test_cpu_tensors_route_to_plain_versions():
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    counts = (fb.fused_attn_block.launches, fb.fused_ln_mlp.launches,
              wa.fused_window_mhsa.launches)
    args = _attn_args("cpu")
    torch.testing.assert_close(fb.fused_attn_block(*args), fb.fused_attn_block_reference(*args),
                               rtol=0, atol=0)
    x, g, be = args[:3]
    c = x.shape[-1]
    mlp = (x, g, be, torch.ones(c, 2 * c), torch.zeros(2 * c), torch.ones(2 * c, c),
           torch.zeros(c), torch.ones(1), 8)
    torch.testing.assert_close(fb.fused_ln_mlp(*mlp), fb.fused_ln_mlp_reference(*mlp),
                               rtol=0, atol=0)
    qkv = torch.randn(1, 8, 8, 48)
    bias = torch.zeros(1, 2, 64, 64)
    torch.testing.assert_close(wa.fused_window_mhsa(qkv, bias, 2, 8, 8),
                               wa.fused_window_mhsa_reference(qkv, bias, 2, 8, 8),
                               rtol=0, atol=0)
    assert counts == (fb.fused_attn_block.launches, fb.fused_ln_mlp.launches,
                      wa.fused_window_mhsa.launches)


def test_other_devices_raise_not_fall_back():
    """A tensor neither on the CPU nor on CUDA is refused: no silent fallback
    to the plain version."""
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    args = _attn_args("meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb.fused_attn_block(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wa.fused_window_mhsa(torch.empty(1, 8, 8, 48, device="meta"),
                             torch.empty(1, 2, 64, 64, device="meta"), 2, 8, 8)


def test_chip_smoke_fails_without_card(tmp_path):
    """No card here: chip_smoke exits non-zero and prints no result, also
    from a directory that holds chip_smoke.py and nothing else."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, lone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
