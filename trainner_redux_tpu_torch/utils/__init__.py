from trainner_redux_tpu_torch.utils.logger import get_env_info, get_root_logger
from trainner_redux_tpu_torch.utils.misc import (
    get_time_str,
    make_exp_dirs,
    mkdir_and_rename,
    scandir,
)
from trainner_redux_tpu_torch.utils.registry import (
    ARCH_REGISTRY,
    DATASET_REGISTRY,
    METRIC_REGISTRY,
    MODEL_REGISTRY,
)
