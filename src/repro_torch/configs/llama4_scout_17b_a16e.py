"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import LLAMA4_SCOUT

CONFIG = LLAMA4_SCOUT
