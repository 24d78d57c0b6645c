"""DRCT's training steps against the JAX package, on the CPU: three L1
`SRModel` steps (AdamW, EMA) of the golden `drct` config
(tests/test_torch_drct.py's GOLDEN) against the JAX `SRModel` within 1e-5
(tests/test_torch_srformer.py's `three_steps_match_jax`).
"""

from tests.test_torch_drct import GOLDEN
from tests.test_torch_srformer import three_steps_match_jax
from tests.test_torch_train import dataset  # noqa: F401 (a fixture)
from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)


def test_three_steps_match_jax(dataset, tmp_path, monkeypatch):  # noqa: F811
    three_steps_match_jax(GOLDEN, "DRCT", dataset, tmp_path, monkeypatch)
