"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import KIMI_K2

CONFIG = KIMI_K2
