"""Run configuration: the reference's per-dataset hyperparameter sets.

Counterpart of gat_pytorch_tpu/utils/config.py, with the same values.
The CLI overlays its flags on these (cli/train.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..models.gat import GATConfig


@dataclasses.dataclass
class RunConfig:
    dataset: str
    num_input_node_features: int
    num_layers: int
    num_heads_per_layer: List[int]
    heads_concat_per_layer: List[bool]
    head_output_features_per_layer: List[int]
    num_classes: int
    add_skip_connection: List[bool]
    dropout: float
    l2_reg: float
    learning_rate: float
    batch_size: int
    num_epochs: int
    const_attention: bool = False
    paper_faithful: bool = False
    attention_reward: float = 0.0
    attention_penalty: float = 0.0
    patience: int = 100
    exec_type: str = "train"
    seed: int = 0
    synthetic: Optional[bool] = None      # None = real data if present
    log_every: int = 0
    backend: str = "kernel"               # kernel | segment
    device: str = "cuda"
    reorder: Optional[str] = None         # "rcm": reorder + block layout

    def gat_config(self) -> GATConfig:
        return GATConfig(
            num_input_node_features=self.num_input_node_features,
            num_layers=self.num_layers,
            num_heads_per_layer=list(self.num_heads_per_layer),
            heads_concat_per_layer=list(self.heads_concat_per_layer),
            head_output_features_per_layer=list(
                self.head_output_features_per_layer),
            num_classes=self.num_classes,
            add_skip_connection=list(self.add_skip_connection),
            dropout=self.dropout,
            const_attention=self.const_attention,
            paper_faithful=self.paper_faithful)


# the reference's values (run_config.py:17-98 of the reference)
DATA_CONFIG = {
    "PPI": RunConfig(
        dataset="PPI", num_input_node_features=50, num_layers=3,
        num_heads_per_layer=[4, 4, 6],
        heads_concat_per_layer=[True, True, False],
        head_output_features_per_layer=[50, 256, 256, 121],
        num_classes=121, add_skip_connection=[False, True, False],
        dropout=0.0, l2_reg=0.0, learning_rate=0.005, batch_size=2,
        num_epochs=1000),
    "PATTERN": RunConfig(
        dataset="PATTERN", num_input_node_features=3, num_layers=4,
        num_heads_per_layer=[4, 4, 4, 1],
        heads_concat_per_layer=[True, True, True, False],
        head_output_features_per_layer=[3, 12, 24, 12, 1],
        num_classes=1, add_skip_connection=[True, True, True, True],
        dropout=0.0, l2_reg=0.0, learning_rate=0.005, batch_size=8,
        num_epochs=1000),
    "Cora": RunConfig(
        dataset="Cora", num_input_node_features=1433, num_layers=2,
        num_heads_per_layer=[8, 1], heads_concat_per_layer=[True, False],
        head_output_features_per_layer=[1433, 8, 7],
        num_classes=7, add_skip_connection=[False, False],
        dropout=0.6, l2_reg=0.0005, learning_rate=0.005, batch_size=1,
        num_epochs=1000),
    "Citeseer": RunConfig(
        dataset="Citeseer", num_input_node_features=3703, num_layers=2,
        num_heads_per_layer=[8, 1], heads_concat_per_layer=[True, False],
        head_output_features_per_layer=[3703, 8, 6],
        num_classes=6, add_skip_connection=[False, False],
        dropout=0.6, l2_reg=0.0005, learning_rate=0.005, batch_size=1,
        num_epochs=1000),
    "Pubmed": RunConfig(
        dataset="Pubmed", num_input_node_features=500, num_layers=2,
        num_heads_per_layer=[8, 8], heads_concat_per_layer=[True, False],
        head_output_features_per_layer=[500, 8, 3],
        num_classes=3, add_skip_connection=[False, False],
        dropout=0.6, l2_reg=0.001, learning_rate=0.01, batch_size=1,
        num_epochs=1000),
}


def get_config(dataset: str, **overrides) -> RunConfig:
    """A copy of the dataset's RunConfig with non-None overrides cast to
    each field's type."""
    cfg = dataclasses.replace(DATA_CONFIG[dataset])
    for k, v in overrides.items():
        if v is None:
            continue
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field {k!r}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v in (True, "true", "True", "1")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        setattr(cfg, k, v)
    return cfg
