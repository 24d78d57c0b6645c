"""The port's device-memory dataset cache (`device_cache: true`,
data/device_cache.py), on the CPU, where the "device" is the CPU itself:

- each LR crop is a window of one source image and its HR crop the same
  window of that image's HR at x scale (images of different sizes, so the
  padding of the stack never shows);
- with the augments on, each pair is one of the 8 dihedral maps of such a
  window pair, the same map for LR and HR, and over a few batches more than
  one map is drawn;
- two feeders with one seed cut the same batches, another seed others; the
  JAX package's feeder draws from another stream, so this is no bit
  comparison with it;
- over TRAINNER_DEVICE_CACHE_MB it raises, as the JAX package's does;
- `train.run` with `device_cache: true` trains from the feeder (the host
  prefetcher is never built) and counts the batches it cut.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_train import _yaml
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

LQ, SCALE, BATCH = 8, 2, 6
SIZES = [(24, 20), (16, 30), (20, 20)]  # LR (h, w) of the three sources


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Three random LR images of different sizes and their (random) HR."""
    root = tmp_path_factory.mktemp("cache_ds")
    (root / "hr").mkdir()
    (root / "lr").mkdir()
    rng = np.random.default_rng(0)
    lrs, hrs = [], []
    for i, (h, w) in enumerate(SIZES):
        lr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        hr = rng.integers(0, 256, (h * SCALE, w * SCALE, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "lr" / f"img{i}.png"), lr)
        cv2.imwrite(str(root / "hr" / f"img{i}.png"), hr)
        lrs.append(lr[..., ::-1])  # the loader decodes to RGB
        hrs.append(hr[..., ::-1])
    return root, lrs, hrs


def _config(root, **ds) -> dict:
    return {
        "name": "device_cache", "scale": SCALE, "num_gpu": 1, "manual_seed": 3,
        "compute_dtype": "float32", "path": {},
        "network_g": {"type": "span", "feature_channels": 8},
        "datasets": {"train": {
            "name": "cache", "type": "PairedImageDataset", "dataroot_gt": str(root / "hr"),
            "dataroot_lq": str(root / "lr"), "lq_size": LQ, "batch_size_per_gpu": BATCH,
            "num_worker_per_gpu": 1, "device_cache": True, **ds}},
        "train": {"total_iter": 3, "optim_g": {"type": "AdamW", "lr": 1e-4},
                  "losses": [{"type": "l1loss", "loss_weight": 1.0}]},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 1000, "use_tb_logger": False},
    }


def _options(tmp_path, cfg: dict):
    from trainner_redux_tpu_torch.utils.options import parse_options

    return parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])[0]


def _feeder(tmp_path, root, seed: int = 0, **ds):
    from trainner_redux_tpu_torch.data import build_dataset
    from trainner_redux_tpu_torch.data.device_cache import DeviceCacheFeeder

    opt = _options(tmp_path, _config(root, **ds))
    ds_opt = opt.datasets["train"]
    return DeviceCacheFeeder(build_dataset(ds_opt, seed=0), ds_opt, BATCH, "cpu", seed)


def _dihedral(img: np.ndarray) -> list[np.ndarray]:
    """The 8 maps of an HWC square, in the augment's order of coin flips."""
    out = []
    for h in (False, True):
        for v in (False, True):
            for t in (False, True):
                m = img[:, ::-1] if h else img
                m = m[::-1] if v else m
                out.append(m.transpose(1, 0, 2) if t else m)
    return out


def _all_maps(lrs, hrs) -> list[tuple[int, bytes, bytes]]:
    """(d, LR window, HR window) under each dihedral map d, for every
    window pair of the sources, as bytes."""
    out = []
    for lr, hr in zip(lrs, hrs):
        for y in range(lr.shape[0] - LQ + 1):
            for x in range(lr.shape[1] - LQ + 1):
                wl = lr[y:y + LQ, x:x + LQ]
                wg = hr[y * SCALE:(y + LQ) * SCALE, x * SCALE:(x + LQ) * SCALE]
                out += [(d, np.ascontiguousarray(ml).tobytes(), np.ascontiguousarray(mg).tobytes())
                        for d, (ml, mg) in enumerate(zip(_dihedral(wl), _dihedral(wg)))]
    return out


def _match(lq: np.ndarray, gt: np.ndarray, maps) -> set[int]:
    """The dihedral maps d with (lq, gt) == (d(window), d(HR window)) for
    some window pair of the sources."""
    lb, gb = lq.tobytes(), gt.tobytes()
    return {d for d, ml, mg in maps if ml == lb and mg == gb}


def test_crops_are_matching_windows(sources, tmp_path):
    root, lrs, hrs = sources
    feeder = _feeder(tmp_path, root, use_hflip=False, use_rot=False)
    maps = _all_maps(lrs, hrs)
    for _ in range(2):
        batch = feeder.next()
        lq, gt = batch["lq"].numpy(), batch["gt"].numpy()
        assert batch["lq"].dtype == torch.uint8 and lq.shape == (BATCH, LQ, LQ, 3)
        assert gt.shape == (BATCH, LQ * SCALE, LQ * SCALE, 3)
        for i in range(BATCH):
            assert _match(lq[i], gt[i], maps) == {0}, f"sample {i}"
    assert feeder.batches_cut == 2


def test_augments_are_dihedral_maps(sources, tmp_path):
    root, lrs, hrs = sources
    feeder = _feeder(tmp_path, root, seed=1)
    maps, seen = _all_maps(lrs, hrs), set()
    for _ in range(3):
        batch = feeder.next()
        for lq, gt in zip(batch["lq"].numpy(), batch["gt"].numpy()):
            found = _match(lq, gt, maps)
            assert found, "a pair that is no dihedral map of a window pair"
            seen |= found
    assert len(seen) > 1


def test_same_seed_same_batches(sources, tmp_path):
    root, _, _ = sources
    a, b, c = (_feeder(tmp_path, root, seed=s) for s in (7, 7, 8))
    for _ in range(3):
        ba, bb, bc = a.next(), b.next(), c.next()
        for k in ("lq", "gt"):
            torch.testing.assert_close(ba[k], bb[k], rtol=0, atol=0)
    assert not torch.equal(ba["gt"], bc["gt"])


def test_over_cap_raises(sources, tmp_path, monkeypatch):
    root, _, _ = sources
    monkeypatch.setenv("TRAINNER_DEVICE_CACHE_MB", "0.001")
    with pytest.raises(ValueError, match="exceeds TRAINNER_DEVICE_CACHE_MB"):
        _feeder(tmp_path, root)


def test_train_run_cuts_batches_on_the_device(sources, tmp_path, monkeypatch):
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.data import device_cache, loader

    root, _, _ = sources
    feeders = []
    real_init = device_cache.DeviceCacheFeeder.__init__

    def record(self, *a, **k):
        real_init(self, *a, **k)
        feeders.append(self)

    def no_host_prefetch(*a, **k):
        raise AssertionError("the host prefetcher was built")

    monkeypatch.setattr(device_cache.DeviceCacheFeeder, "__init__", record)
    monkeypatch.setattr(loader.DevicePrefetcher, "__init__", no_host_prefetch)
    model = port_train.run(_options(tmp_path, _config(root)), device="cpu")
    assert model.step == 3 and len(feeders) == 1 and feeders[0].batches_cut == 3
    assert np.isfinite(model.get_current_log()["l_g_total"])
