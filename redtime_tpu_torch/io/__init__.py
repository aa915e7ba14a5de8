from redtime_tpu_torch.io.params import ParamsFile, read_params_file  # noqa: F401
from redtime_tpu_torch.io.camb import (  # noqa: F401
    read_transfer_file, load_linear_data, LinearData,
)
