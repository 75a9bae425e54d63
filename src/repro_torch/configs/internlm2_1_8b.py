"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import INTERNLM2_1_8B

CONFIG = INTERNLM2_1_8B
