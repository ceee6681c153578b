"""Configuration of the PyTorch port (counterpart of `dualpixelface_tpu/config/`):
the 4-layer run configuration with its workspace (`Configuration`) and the
merge-only `load_config` of the profilers, the bench script and the tests."""
from dualpixelface_tpu_torch.config.manager import Config, Configuration, load_config

__all__ = ["Config", "Configuration", "load_config"]
