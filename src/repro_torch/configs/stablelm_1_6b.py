"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import STABLELM_1_6B

CONFIG = STABLELM_1_6B
