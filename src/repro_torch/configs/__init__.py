from repro_torch.configs.base import (ARCH_IDS, PORTED_ARCH_IDS, LayerSpec,
                                      ModelConfig, Segment, all_configs,
                                      get_config, reduced, register)
from repro_torch.configs.weips_ctr import (CTR_CONFIGS, DNN_ADAM, FM_FTRL,
                                           FM_SGD, LR_FTRL, CTRConfig)

__all__ = ["ARCH_IDS", "CTR_CONFIGS", "CTRConfig", "DNN_ADAM", "FM_FTRL",
           "FM_SGD", "LR_FTRL", "LayerSpec", "ModelConfig",
           "PORTED_ARCH_IDS", "Segment", "all_configs", "get_config",
           "reduced", "register"]
