"""Config loading: YAML files and the port's copies of the JAX presets."""

from nrse_tpu_torch.config.config_utils import (
    get_config,
    load_config,
    parse_args,
    preset_path,
)

__all__ = ["load_config", "parse_args", "get_config", "preset_path"]
