"""Architecture registry: importing this package registers every config.

``--arch <id>`` in the launchers resolves through ``repro_torch.config.get_config``.
"""

from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    phi3_mini,
    granite_20b,
    llama32_3b,
    deepseek_v3,
    arctic_480b,
    zamba2_2p7b,
    llava_next_mistral,
    rwkv6_1p6b,
    whisper_tiny,
    xtime_tabular,
)

ASSIGNED_ARCHS = [
    "gemma3-1b",
    "phi3-mini-3.8b",
    "granite-20b",
    "llama3.2-3b",
    "deepseek-v3-671b",
    "arctic-480b",
    "zamba2-2.7b",
    "llava-next-mistral-7b",
    "rwkv6-1.6b",
    "whisper-tiny",
]

ALL_ARCHS = ASSIGNED_ARCHS + ["xtime-tabular"]
