"""The paper's own model family: large-scale sparse CTR models served by the
WeiPS parameter server — LR-FTRL, FM-FTRL, FM-SGD, DNN (paper §4.1.2:
"LR-FTRL has 3 sparse matrices, FM-FTRL has 6, FM-SGD has 2, DNN is multiple
sparse plus multiple dense matrices").

Features are hashed into a huge sparse ID space; only touched rows exist on
the PS (row-addressable sparse tables, see core/ps.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CTRConfig:
    name: str = "weips-ctr"
    model_type: str = "fm"          # "lr" | "fm" | "dnn"
    feature_space: int = 2 ** 22    # hashed sparse feature ID space
    fields: int = 32                # feature fields per example
    embed_dim: int = 8              # FM latent dim / DNN embedding dim
    dnn_hidden: tuple[int, ...] = (128, 64)
    optimizer: str = "ftrl"         # "ftrl" | "sgd" | "adagrad" | "adam"
    # FTRL hyper-parameters (McMahan 2011)
    ftrl_alpha: float = 0.05
    ftrl_beta: float = 1.0
    ftrl_l1: float = 1.0
    ftrl_l2: float = 1.0
    lr: float = 0.05                # for sgd/adagrad/adam variants


LR_FTRL = CTRConfig(name="weips-lr-ftrl", model_type="lr", embed_dim=1,
                    optimizer="ftrl")
FM_FTRL = CTRConfig(name="weips-fm-ftrl", model_type="fm", optimizer="ftrl")
FM_SGD = CTRConfig(name="weips-fm-sgd", model_type="fm", optimizer="sgd")
DNN_ADAM = CTRConfig(name="weips-dnn-adam", model_type="dnn", optimizer="adam")

CTR_CONFIGS = {c.name: c for c in (LR_FTRL, FM_FTRL, FM_SGD, DNN_ADAM)}
