"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import ZAMBA2_7B

CONFIG = ZAMBA2_7B
