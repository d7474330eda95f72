"""Frozen, JSON-round-trippable configuration: the port's own copy of
``recsys_tpu/config.py``.

Field names, defaults and the JSON layout are identical to the JAX
package's, so one ``config.json`` loads in both packages; the port's one
addition, the fields of a second architecture (``ModelConfig.arch``
"dlrm_dcnv2"), stays out of a two-tower config's JSON. The port keeps
the fields it does not act on yet (training, mesh, the TPU dispatch
knobs) so that a bundle written by either package round-trips unchanged.
Comments here say what a field means to the port; the measurements
behind the defaults are the JAX package's and are documented there.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return {k: _freeze(v) for k, v in value.items()}
    return value


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (the two-tower encoder, the DCN trunk and the
    rating / CTR heads)."""

    embedding_dim: int = 128
    user_tower_dims: Tuple[int, ...] = (256, 128, 64)
    item_tower_dims: Tuple[int, ...] = (256, 128, 64)
    cross_layers: int = 3
    dnn_dims: Tuple[int, ...] = (256, 128)
    dropout_rate: float = 0.2
    l2_reg: float = 1e-4
    retrieval_weight: float = 1.0
    ctr_weight: float = 2.0
    rating_weight: float = 0.2
    explicit_negatives_weight: float = 1.0
    # bfloat16 operands with fp32 accumulation in the towers and the DCN
    # deep branch (params stay fp32); see models/layers.py::dense
    mixed_precision: bool = True
    bf16_retrieval_logits: Any = "auto"
    # residual connection around each tower MLP (out = emb + MLP(emb))
    tower_residual: bool = True
    # a TPU dispatch choice in the JAX package. The port always runs the
    # cross stack in fp32 through ops/dcn_cross.py, whatever this says.
    use_pallas_dcn: bool = False
    use_flash_ce: Any = "auto"
    retrieval_logits_cap_gb: float = 8.0
    # width of the engineered dense-feature vector in the DCN input
    # (data/features.py: FeatureEngineer.n_features); 0 = none
    dense_features: int = 0
    softmax_temperature: float = 1.0
    use_item_bias: bool = True
    accidental_hit_mask: bool = True
    # The architecture: "two_tower_dcn" (the fields above) or "dlrm_dcnv2"
    # (models/dlrm.py: DLRM with a low-rank DCNv2 interaction, which reads
    # embedding_dim, cross_layers, mixed_precision and the fields below).
    # The JAX package has only the first and ignores these fields.
    arch: str = "two_tower_dcn"
    dlrm_dense_in: int = 13
    # rows of each categorical table, their fixed multi-hot bag sizes, and
    # the rows each table's init bound is drawn for (default: table_rows;
    # a table cut to one card's rows keeps its published bound)
    table_rows: Tuple[int, ...] = ()
    bag_sizes: Tuple[int, ...] = ()
    table_init_rows: Tuple[int, ...] = ()
    bottom_mlp_dims: Tuple[int, ...] = (512, 256, 128)
    over_arch_dims: Tuple[int, ...] = (1024, 1024, 512, 256)
    dcn_low_rank_dim: int = 512

    def __post_init__(self):
        for name in ("user_tower_dims", "item_tower_dims", "dnn_dims", "table_rows",
                     "bag_sizes", "table_init_rows", "bottom_mlp_dims", "over_arch_dims"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        if self.arch not in ("two_tower_dcn", "dlrm_dcnv2"):
            raise ValueError(f"arch must be two_tower_dcn|dlrm_dcnv2, got {self.arch!r}")
        if self.arch == "dlrm_dcnv2":
            if not self.table_rows or len(self.bag_sizes) != len(self.table_rows):
                raise ValueError("dlrm_dcnv2 needs table_rows and one bag size a table")
            if self.table_init_rows and len(self.table_init_rows) != len(self.table_rows):
                raise ValueError("table_init_rows needs one count a table")
            if self.bottom_mlp_dims[-1:] != (self.embedding_dim,):
                raise ValueError(f"the bottom MLP must end at embedding_dim "
                                 f"{self.embedding_dim}, got {self.bottom_mlp_dims}")


# the ModelConfig fields of the dlrm_dcnv2 architecture
DLRM_MODEL_KEYS = ("arch", "dlrm_dense_in", "table_rows", "bag_sizes", "table_init_rows",
                   "bottom_mlp_dims", "over_arch_dims", "dcn_low_rank_dim")


@dataclass(frozen=True)
class DataConfig:
    """Data and preprocessing knobs."""

    data_dir: str = "data/raw"
    processed_path: str = "data/processed/processed_data.npz"
    implicit_threshold: float = 4.0
    train_frac: float = 0.8
    val_frac: float = 0.1
    negative_sampling: str = "random"  # random | hard | mixed | mined
    num_hard_negatives: int = 5
    num_random_negatives: int = 10
    mined_from: str = ""
    mined_pool_size: int = 50
    mined_skip_top: int = 10
    synthetic_num_ratings: int = 1_000_209
    synthetic_seed: int = 1

    def __post_init__(self):
        if self.negative_sampling not in ("random", "hard", "mixed", "mined"):
            raise ValueError(
                f"negative_sampling must be random|hard|mixed|mined, "
                f"got {self.negative_sampling!r}"
            )


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs. The port's trainer raises for the modes it does
    not run yet (``recsys_tpu_torch/train/trainer.py``)."""

    batch_size: int = 2048
    learning_rate: float = 1e-3
    learning_rate_ranking: Optional[float] = None
    epochs: int = 20
    warmup_steps: int = 0
    lr_decay_steps: int = 1000
    lr_decay_rate: float = 0.96
    lr_staircase: bool = True
    clipnorm: float = 1.0
    optimizer: str = "adagrad"
    early_stop_patience: int = 20
    early_stop_metric: str = "val_loss"
    eval_every_epochs: int = 0
    seed: int = 42
    use_class_weights: bool = True
    logq_correction: bool = True
    global_negatives: bool = True
    checkpoint_every_steps: int = 0
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    resume: bool = False
    log_every_steps: int = 50
    donate_state: bool = True
    device_resident_data: bool = True
    device_data_limit_mb: int = 2048
    profile: bool = False
    stream_chunk_steps: int = 32
    sparse_table_updates: Any = "auto"
    negative_cache: int = 0
    debug_nans: bool = False
    checkpoint_on_preemption: bool = True
    replication_check_every_epochs: int = 0
    dropout_rng_impl: str = "rbg"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh topology: a ``(data, model)`` mesh (``data_axis`` -1:
    every rank not on the model axis). With ``embedding_sharding="rows"``
    and ``model_axis > 1`` the tables are row-sharded over ``model`` and
    read through the ``lookup_strategy`` (psum or a2a; "xla" takes the psum
    body in the port), the a2a buckets sized by ``lookup_capacity_factor``."""

    data_axis: int = -1
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    embedding_sharding: str = "replicated"
    lookup_strategy: str = "xla"
    lookup_capacity_factor: float = 2.0

    def __post_init__(self):
        if self.embedding_sharding not in ("replicated", "rows"):
            raise ValueError(
                f"embedding_sharding must be replicated|rows, got {self.embedding_sharding!r}"
            )
        if self.lookup_strategy not in ("xla", "psum", "a2a"):
            raise ValueError(
                f"lookup_strategy must be xla|psum|a2a, got {self.lookup_strategy!r}"
            )


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation knobs."""

    topk: Tuple[int, ...] = (5, 10, 20, 50)
    eval_sample: int = 0
    eval_batch_size: int = 4096
    filter_seen: bool = False
    # "cosine" = L2-normalized dot; "dot" = raw dot + item bias
    score_norm: str = "cosine"

    def __post_init__(self):
        object.__setattr__(self, "topk", tuple(self.topk))
        if self.score_norm not in ("cosine", "dot"):
            raise ValueError(f"score_norm must be cosine|dot, got {self.score_norm!r}")


@dataclass(frozen=True)
class RecsysConfig:
    """Top-level bundle, JSON round-trippable via :meth:`to_dict` /
    :meth:`from_dict` and :meth:`save` / :meth:`load`."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> Dict[str, Any]:
        """The JSON layout; a two-tower config leaves out the other
        architecture's keys, so its ``config.json`` is the JAX package's."""
        d = dataclasses.asdict(self)
        if self.model.arch == "two_tower_dcn":
            for k in DLRM_MODEL_KEYS:
                del d["model"][k]
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecsysConfig":
        sub_classes = {
            "model": ModelConfig,
            "data": DataConfig,
            "train": TrainConfig,
            "mesh": MeshConfig,
            "eval": EvalConfig,
        }
        sections = {}
        for name, sub_cls in sub_classes.items():
            sub = d.get(name, {})
            known = {sf.name for sf in dataclasses.fields(sub_cls)}
            kwargs = {k: _freeze(v) for k, v in sub.items() if k in known}
            sections[name] = sub_cls(**kwargs)
        return cls(**sections)

    def replace(self, **sections: Any) -> "RecsysConfig":
        """A copy with whole sections (``model=...``) or dotted fields
        (``**{"train.epochs": 5}``) replaced; an unknown field raises."""
        plain = {k: v for k, v in sections.items() if "." not in k}
        dotted = {k: v for k, v in sections.items() if "." in k}
        out = dataclasses.replace(self, **plain) if plain else self
        if dotted:
            d = dataclasses.asdict(out)
            for key, value in dotted.items():
                sec, name = key.split(".", 1)
                if sec not in d or name not in d[sec]:
                    raise KeyError(f"unknown config field {key!r}")
                d[sec][name] = value
            out = RecsysConfig.from_dict(d)
        return out

    @classmethod
    def from_json(cls, s: str) -> "RecsysConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "RecsysConfig":
        with open(path) as f:
            return cls.from_json(f.read())
