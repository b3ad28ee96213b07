"""xtime-tabular: the paper's own workload as the 11th selectable config.

A maximum-size ensemble per the paper's hardware constraint search
(§V-A 'X-TIME 8bit'): N_trees=4096, N_leaves,max=256, N_feat=130 (the
gas-concentration outlier width), 8-bit bins — CAM rows sharded on the
mesh `model` axis, query batch on `data`(×`pod`), NoC reduction = psum.
"""

from repro_torch.config import XTimeConfig, register

CONFIG = register(XTimeConfig(
    name="xtime-tabular",
    n_trees=4096,
    max_leaves=256,
    n_features=130,
    n_bins=256,
    n_classes=8,
    task="multiclass",
))


def smoke() -> XTimeConfig:
    import dataclasses

    return dataclasses.replace(CONFIG, n_trees=64, max_leaves=32, n_features=16,
                               n_classes=3)
