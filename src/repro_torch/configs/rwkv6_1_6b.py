"""--arch config (assignment-exact); see configs/base.py."""
from repro_torch.configs.base import RWKV6_1_6B

CONFIG = RWKV6_1_6B
