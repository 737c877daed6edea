from repro_torch.configs.base import (ARCH_IDS, PORT_ONLY_ARCH_IDS,
                                      PORTED_ARCH_IDS, LayerSpec,
                                      ModelConfig, PortModelConfig, Segment,
                                      all_configs, get_config, reduced,
                                      register)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K, InputShape,
                                        applicable)
from repro_torch.configs.weips_ctr import (CTR_CONFIGS, DNN_ADAM, FM_FTRL,
                                           FM_SGD, LR_FTRL, CTRConfig)

__all__ = ["ARCH_IDS", "CTR_CONFIGS", "CTRConfig", "DECODE_32K", "DNN_ADAM",
           "FM_FTRL", "FM_SGD", "InputShape", "LONG_500K", "LR_FTRL",
           "LayerSpec", "ModelConfig", "PORTED_ARCH_IDS",
           "PORT_ONLY_ARCH_IDS", "PREFILL_32K", "PortModelConfig",
           "SHAPES", "Segment", "TRAIN_4K", "all_configs", "applicable",
           "get_config", "reduced", "register"]
