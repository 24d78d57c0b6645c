"""Two options the port used to ignore in silence, on the CPU.

- `train.bn_recalibrate_batches`: a tiny DAT (embed 96, two groups of two
  blocks, 2x) trained two steps by the port, its online and EMA weights
  read by the JAX `SRModel`, then `SRModel.recalibrate_bn` in both over the
  same two LQ batches: every
  BatchNormNoStats running mean and variance, online and EMA, within 1e-5
  of the JAX `SRModel`'s (JAX on its plain XLA path, as on a CPU it runs).
  A loader without `lq` (the OTF one) leaves them as they are, as in JAX;
  `train.run` recalibrates before its final save when the option asks.
- a train dataset's `device_cache: true` (the device-memory feeder) builds
  its loader, and the feeder refuses, by name, a dataset above
  TRAINNER_DEVICE_CACHE_MB instead of falling back to the host loader, as
  the JAX package's does (the feeder itself: tests/test_torch_device_cache.py).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dat import _config as dat_config
from tests.test_torch_dat import _jax_flat, _to_port
from tests.test_torch_train import _config, _opts, _yaml, dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

STAT_TOL = 1e-5


def _bn_stats(net: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_recalibrate_bn_matches_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    """The port trains the two steps; the JAX `SRModel` then reads the
    port's online and EMA weights (its torch-checkpoint converter), so both
    recalibrate the same networks."""
    from safetensors.numpy import save_file

    from trainner_redux_tpu.models import build_model as jbuild_model
    from trainner_redux_tpu_torch.models import build_model

    monkeypatch.delenv("TRAINNER_FUSED_BLOCK", raising=False)
    monkeypatch.delenv("TRAINNER_FUSED_ATTN", raising=False)
    _, flat = _jax_flat(2)
    weights = tmp_path / "net_g.safetensors"
    save_file(flat, str(weights), metadata={"framework": "trainner_redux_tpu", "arch": "dat"})
    _, opt = _opts(tmp_path, dat_config(dataset, weights))
    model = build_model(opt, device="cpu")
    rng = np.random.default_rng(9)
    batches = [{"lq": rng.integers(0, 256, (2, 12, 12, 3), dtype=np.uint8),
                "gt": rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)} for _ in range(4)]
    for i, batch in enumerate(batches[:2], start=1):
        model.feed_data(batch)
        model.optimize_parameters(i)
    trained = {}
    for name, net in (("online", model.net_g), ("ema", model.net_g_ema)):
        trained[name] = tmp_path / f"{name}.safetensors"
        model.save_network_safetensors(net, str(trained[name]), {"arch": "dat"})
    jopt, _ = _opts(tmp_path, dat_config(dataset, trained["online"]))
    jmodel = jbuild_model(jopt)
    jopt, _ = _opts(tmp_path, dat_config(dataset, trained["ema"]))
    jmodel.state = jmodel.state.replace(ema_params_g=jbuild_model(jopt).state.params_g)
    before = {name: _bn_stats(net) for name, net in (("online", model.net_g),
                                                     ("ema", model.net_g_ema))}
    for name, jparams in (("online", jmodel.state.params_g), ("ema", jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        for k, v in before[name].items():
            np.testing.assert_array_equal(v, want[k], err_msg=f"{name} {k} before")

    # an OTF loader carries no lq: nothing changes
    model.recalibrate_bn([{"gt": b["gt"]} for b in batches], num_batches=2)
    for k, v in _bn_stats(model.net_g).items():
        np.testing.assert_array_equal(v, before["online"][k])

    jmodel.recalibrate_bn(batches[2:], num_batches=2)
    model.recalibrate_bn(batches[2:], num_batches=2)
    for name, net, jparams in (("online", model.net_g, jmodel.state.params_g),
                               ("ema", model.net_g_ema, jmodel.state.ema_params_g)):
        want = _to_port(jparams)
        got = _bn_stats(net)
        assert len(got) == 24  # 12 BatchNorms: 3 in each of the 4 blocks' two branches
        for k, v in got.items():
            assert np.abs(v - before[name][k]).max() > 1e-3, f"{name} {k} did not move"
            np.testing.assert_allclose(v, want[k], rtol=0, atol=STAT_TOL, err_msg=f"{name} {k}")


def test_train_run_recalibrates_before_the_final_save(dataset, tmp_path, monkeypatch):  # noqa: F811
    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.models.sr_model import SRModel
    from trainner_redux_tpu_torch.utils.options import parse_options

    calls = []
    monkeypatch.setattr(SRModel, "recalibrate_bn",
                        lambda self, loader, num_batches=50: calls.append((self.step, num_batches)))
    cfg = _config(dataset)
    cfg["train"].update(total_iter=1, bn_recalibrate_batches=3)
    opt, _ = parse_options(str(tmp_path), is_train=True, argv=["-opt", _yaml(tmp_path, cfg)])
    port_train.run(opt, device="cpu")
    assert calls == [(1, 3)]


def test_device_cache_is_refused(dataset, tmp_path, monkeypatch):  # noqa: F811
    """Over TRAINNER_DEVICE_CACHE_MB the device cache raises by name; the
    loader itself builds."""
    from trainner_redux_tpu_torch.data import build_dataloader, build_dataset
    from trainner_redux_tpu_torch.data.device_cache import DeviceCacheFeeder

    cfg = _config(dataset)
    cfg["datasets"]["train"]["device_cache"] = True
    _, opt = _opts(tmp_path, cfg)
    ds_opt = opt.datasets["train"]
    ds = build_dataset(ds_opt, seed=0)
    loader = build_dataloader(ds, ds_opt)
    monkeypatch.setenv("TRAINNER_DEVICE_CACHE_MB", "0.01")
    with pytest.raises(ValueError, match="device_cache: .* exceeds TRAINNER_DEVICE_CACHE_MB"):
        DeviceCacheFeeder(ds, ds_opt, loader.batch_size, "cpu")
