"""Architecture configs and the dry-run's shape cells (a copy of
``repro.configs``). ``ARCH_NAMES``: every registered architecture."""
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY, SHAPES, ArchConfig, ShapeConfig, applicable_shapes, get_config,
)
from repro_torch.configs import mistral_nemo_12b  # noqa: F401
from repro_torch.configs import command_r_35b  # noqa: F401
from repro_torch.configs import grok_1_314b  # noqa: F401
from repro_torch.configs import llama4_maverick_400b  # noqa: F401
from repro_torch.configs import granite_3_8b  # noqa: F401
from repro_torch.configs import qwen2_5_14b  # noqa: F401
from repro_torch.configs import mamba2_1_3b  # noqa: F401
from repro_torch.configs import zamba2_2_7b  # noqa: F401
from repro_torch.configs import internvl2_2b  # noqa: F401
from repro_torch.configs import whisper_base  # noqa: F401

ARCH_NAMES = sorted(REGISTRY)
