"""Three bf16 `SRModel` steps of a 240-wide SwinIR-L (its blocks on the
unfused branch: #3/#8's bf16 forms at 8x8 windows, the MLP in bf16) against
the JAX `SRModel`, as tests/test_torch_bf16_family_steps.py holds HAT and
DAT (its `three_bf16_steps`, with the same limits); a file of its own so
that each file stays within about a minute and a half on the CPU.
"""

from tests.test_torch_bf16_family_steps import dataset, three_bf16_steps  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


def test_three_bf16_swinir_l_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    three_bf16_steps("SwinIR", dataset, tmp_path, monkeypatch)
