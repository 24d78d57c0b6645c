"""SRModel, evaluation half: the serving path of `test.py`.

Port of the JAX package's models/sr_model.py for `is_train: false`:
`__init__` (network, seeded init, pretrained weights), `load_network` for
the three checkpoint formats, `test` (reflect-pad to a multiple of 16, one
forward, crop) and `nondist_validation` (per image: save PNG, PSNR/SSIM).
Training, tiled inference and the mesh-sharded paths are not ported yet.
"""

from __future__ import annotations

from contextlib import contextmanager
from os import path as osp

import numpy as np
import torch

from trainner_redux_tpu_torch.archs import build_network
from trainner_redux_tpu_torch.metrics import calculate_metric
from trainner_redux_tpu_torch.models.base_model import BaseModel
from trainner_redux_tpu_torch.utils.img_util import imwrite, tensor2img
from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
from trainner_redux_tpu_torch.utils.registry import MODEL_REGISTRY

_PAD_MULT = 16


@contextmanager
def fp32_math():
    """Full fp32 matmuls and convolutions (TF32 off), as the JAX package's
    fp32 evaluation twin computes."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: ReduxOptions, device: str | torch.device | None = None) -> None:
        super().__init__(opt, device)
        assert opt.network_g is not None, "network_g is required"
        if self.is_train:
            raise NotImplementedError("training is not ported to torch yet")
        if opt.input_pixel_format != "rgb" or opt.output_pixel_format != "rgb":
            raise NotImplementedError("only rgb pixel formats are ported to torch yet")
        if opt.val and opt.val.tile_size:
            raise NotImplementedError("tiled inference is not ported to torch yet")
        self.scale = opt.scale
        net = build_network({**opt.network_g, "scale": opt.scale})
        generator = torch.Generator().manual_seed(opt.manual_seed or 0)
        net.init_weights(generator)
        self.logger.info(
            f"Network [bold]{type(net).__name__}[/bold] created, "
            f"{self.param_count(net):,d} params."
        )
        if opt.path.pretrain_network_g:
            self.load_network(net, opt.path.pretrain_network_g, strict=opt.path.strict_load_g)
        self.net_g = net.to(self.device).eval()
        self.output = None

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def test(self, lq: np.ndarray) -> np.ndarray:
        """Super-resolve NHWC [0,1] numpy images; returns NHWC numpy output."""
        lq = np.asarray(lq)
        if lq.dtype == np.uint8:
            lq = lq.astype(np.float32) / 255.0
        lq = np.asarray(lq, np.float32)
        if lq.ndim == 3:
            lq = lq[None]
        h, w = lq.shape[1], lq.shape[2]
        ph = (_PAD_MULT - h % _PAD_MULT) % _PAD_MULT
        pw = (_PAD_MULT - w % _PAD_MULT) % _PAD_MULT
        if ph or pw:
            lq = np.pad(lq, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect")
        x = torch.from_numpy(np.ascontiguousarray(lq.transpose(0, 3, 1, 2))).to(self.device)
        with torch.inference_mode(), fp32_math():
            out = self.net_g(x)
        out = out[:, :, : h * self.scale, : w * self.scale]
        self.output = out.permute(0, 2, 3, 1).cpu().numpy()
        return self.output

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img) -> None:
        opt = self.opt
        val_opt = opt.val
        dataset_name = dataloader.dataset.opt.name
        with_metrics = bool(val_opt and val_opt.metrics_enabled and val_opt.metrics)
        metric_results: dict[str, float] = {}
        if with_metrics:
            self._init_best_metric_results(dataset_name, val_opt.metrics)
            metric_results = dict.fromkeys(val_opt.metrics, 0.0)

        pbar = None
        if val_opt and val_opt.pbar:
            from tqdm import tqdm

            pbar = tqdm(total=len(dataloader), unit="image")

        count = 0
        for val_data in dataloader:
            sr = self.test(val_data["lq"])[0]
            gt = val_data.get("gt")
            lq_path = val_data["lq_path"]
            img_name = osp.splitext(osp.basename(
                lq_path if isinstance(lq_path, str) else lq_path[0]
            ))[0]
            sr_img = tensor2img(sr.transpose(2, 0, 1))
            count += 1

            if save_img and opt.path.visualization:
                suffix = val_opt.suffix if val_opt and val_opt.suffix else opt.name
                save_path = osp.join(
                    opt.path.visualization, dataset_name, f"{img_name}_{suffix}.png"
                )
                imwrite(sr_img, save_path)

            if with_metrics and gt is not None:
                gt_img = tensor2img(np.asarray(gt)[0].transpose(2, 0, 1))
                data = {
                    "img": sr_img.astype(np.float32) / 255.0,
                    "img2": gt_img.astype(np.float32) / 255.0,
                }
                for name, m_opt in val_opt.metrics.items():
                    m_opt = dict(m_opt)
                    m_opt.pop("better", None)
                    metric_results[name] += calculate_metric(data, m_opt)

            if pbar is not None:
                pbar.update(1)
                pbar.set_description(f"Test {img_name}")

        if pbar is not None:
            pbar.close()
        if with_metrics and count > 0:
            log_str = f"Validation {dataset_name}\n"
            for name in metric_results:
                metric_results[name] /= count
                self._update_best_metric_result(
                    dataset_name, name, metric_results[name], current_iter
                )
                rec = self.best_metric_results[dataset_name][name]
                log_str += (
                    f"\t # {name}: {metric_results[name]:.4f}"
                    f"\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
                )
                if tb_logger:
                    tb_logger.add_scalar(
                        f"metrics/{dataset_name}/{name}", metric_results[name], current_iter
                    )
            self.logger.info(log_str)
            self.metric_results = metric_results

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def load_network(self, net: torch.nn.Module, path: str, strict: bool = True) -> None:
        """Load weights into `net`: a JAX-framework safetensors (metadata
        `framework: trainner_redux_tpu`, through the weight bridge), a
        torch-layout safetensors, or a .pth/.pt pickle."""
        from trainner_redux_tpu_torch.utils import torch_compat

        if path.endswith(".safetensors"):
            from safetensors import safe_open
            from safetensors.numpy import load_file

            with safe_open(path, framework="numpy") as f:
                metadata = f.metadata() or {}
            if metadata.get("framework") == "trainner_redux_tpu":
                sd = torch_compat.state_dict_from_jax(load_file(path), type(net).__name__)
                self._merge_params(net, sd, strict, path)
                return
        flat = torch_compat.drop_swinir_buffers(torch_compat.load_torch_state_dict(path))
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}
        self._merge_params(net, sd, strict, path)

    def _merge_params(self, net: torch.nn.Module, loaded: dict, strict: bool, path: str) -> None:
        template = net.state_dict()
        missing = set(template) - set(loaded)
        unexpected = set(loaded) - set(template)
        mismatched = {
            k for k in set(template) & set(loaded) if template[k].shape != loaded[k].shape
        }
        if missing or unexpected or mismatched:
            msg = (
                f"Loading {path}: missing={sorted(missing)[:8]} "
                f"unexpected={sorted(unexpected)[:8]} mismatched={sorted(mismatched)[:8]}"
            )
            if strict:
                raise ValueError(msg)
            self.logger.warning(msg)
        usable = {k: v for k, v in loaded.items() if k in template and k not in mismatched}
        net.load_state_dict(usable, strict=False)
