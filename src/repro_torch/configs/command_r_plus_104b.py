"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import COMMAND_R_PLUS_104B

CONFIG = COMMAND_R_PLUS_104B
