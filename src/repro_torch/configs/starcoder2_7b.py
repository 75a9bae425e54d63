"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import STARCODER2_7B

CONFIG = STARCODER2_7B
