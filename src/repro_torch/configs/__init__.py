from repro_torch.configs.weips_ctr import (CTR_CONFIGS, DNN_ADAM, FM_FTRL,
                                           FM_SGD, LR_FTRL, CTRConfig)

__all__ = ["CTR_CONFIGS", "CTRConfig", "DNN_ADAM", "FM_FTRL", "FM_SGD",
           "LR_FTRL"]
