from .base import (ModelConfig, MoECfg, SSMCfg, EncoderCfg, ShapeSpec,
                   SHAPES, runnable, register, get_config, all_configs,
                   reduced, ARCH_IDS, load_all)
