"""Typed configuration tree — the port's own copy of ``msrflute_tpu/config.py``.

FLUTE's six top-level sections and key vocabulary are kept, so the same
YAML drives both packages:

    model_config, dp_config, privacy_metrics_config, strategy,
    server_config, client_config

Trimmed to what the ported slices read: FedAvg over the LR, CNN_FEMNIST,
CIFAR_CNN, ResNet-18/34 with GroupNorm, Shakespeare LSTM, RingLM (local
attention), ECG_CNN and NRMS tasks and over ``model_folder`` plugins, DGA
(softmax weights, local and global DP, quantization, staleness) over the
nlg_gru GRU word LM and the BERT masked LM, the privacy-attack metrics
(``privacy_metrics_config``), every optimizer of the JAX package's factory,
every LR schedule, ``freeze_layer``, server replay, the precision policy
(``server_config.precision``) and ``model_config.dtype``, the
personalization server (per-user local models and convex interpolation),
FedLabels semi-supervision with RandAugment, and the strategies q-FFL,
FedAC, FedBuff (drawn staleness), SCAFFOLD and error-feedback quantization
(host store or device table) and DGA's RL weight hook (``wantRL``, the
``RL`` block), and FedAvg's defenses and privacy: chaos client faults and
corruption (``server_config.chaos``), fluteshield (``robust``), secure
aggregation (``strategy: secure_agg``, ``server_config.secure_agg``) and
local DP with adaptive clipping under FedAvg / FedProx, local DP under
FedAC, FedBuff and EF quantization (``dp_config`` and
``privacy_metrics_config`` under FedLabels are accepted and change
nothing, as in the JAX package), chaos's checkpoint-IO faults and
``preempt_at_round``, checked by :func:`check_defense`, and the round
loop's dispatch plane:
``rounds_per_step``, ``pipeline_depth`` (the ring of dispatched chunks, 0
to ``MAX_PIPELINE_DEPTH``), ``input_staging``, ``checkpoint_async``,
``checkpoint_retry``, ``clients_per_chunk`` and ``dump_norm_stats``,
checked by :func:`check_dispatch` with the JAX schema's messages, every
model option of the one-chip paths (RingLM's ``remat``, ``moe_experts``
and ``flash_attention: "auto"``, BERT's ``mlm_head`` and ``dtype``, NRMS's
``arch``, ``pretrained_model_path``), the eval outputs ``wantLogits`` and
``per_user_stats``, and the keys nothing in the JAX package reads
(:data:`_INERT`, the thirteen schema-only keys among them, accepted and
ignored once :func:`check_inert` passes their types), ``do_profiling``,
``fleet.sampling``, the lazy train split (``lazy``,
``lazy_cache_users``) and the arrival plane (``traffic``), checked by
:func:`check_parity` with the JAX schema's messages.  The
combinations that the JAX constructors and round engine refuse are refused
here, by :func:`check_strategy`, with ``ValueError`` and the JAX package's
meaning.
:func:`validate` replaces the JAX package's ``schema.py`` for those
slices: a key the port runs is accepted, a key that only tunes how the TPU
program is dispatched (and changes no result) is accepted and ignored, and
every other key fails loudly — an unknown key with ``ValueError``, a
feature the port does not have yet with ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

NOT_PORTED = "not yet ported; see ROADMAP.md"
#: ``server.py:224-233``'s refusal of ``chaos.infra`` without the paged carry
INFRA_NEEDS_PAGING = (
    "server_config.chaos.infra requires fleet paged carry — "
    "the infra fault streams target the fleet host services "
    "(row-store spill/read, the fleet-prefetch daemon, the "
    "writeback fetch, the round marker), which only exist "
    "under server_config.fleet with a fused_carry "
    "device-carry strategy (scaffold / ef_quant / "
    "personalized); zero the infra rates or enable fleet "
    "paging")


class Config(MutableMapping):
    """Dict-compatible config base: sections behave both as attributes and
    as mapping items; unknown keys live in ``extra``."""

    def _field_names(self) -> List[str]:
        return [f.name for f in dataclasses.fields(self)]  # type: ignore[arg-type]

    def __getitem__(self, key: str) -> Any:
        if key in self._field_names():
            return getattr(self, key)
        extra = getattr(self, "extra", None)
        if extra is not None and key in extra:
            return extra[key]
        raise KeyError(key)

    def __setitem__(self, key: str, value: Any) -> None:
        if key in self._field_names():
            setattr(self, key, value)
        else:
            getattr(self, "extra")[key] = value

    def __delitem__(self, key: str) -> None:
        if key in self._field_names():
            setattr(self, key, None)
        else:
            del getattr(self, "extra")[key]

    def __iter__(self):
        for name in self._field_names():
            if name != "extra" and getattr(self, name) is not None:
                yield name
        for key in getattr(self, "extra", {}):
            yield key

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            value = self[key]
        except KeyError:
            return default
        return default if value is None else value


def _take(raw: Dict[str, Any], known: List[str]) -> Dict[str, Any]:
    kwargs = {k: raw[k] for k in known if k in raw}
    kwargs["extra"] = {k: copy.deepcopy(v) for k, v in raw.items()
                       if k not in known}
    return kwargs


@dataclass
class OptimizerConfig(Config):
    """The JAX package's fields and defaults (``msrflute_tpu/config.py``):
    the factory reads ``cfg.get(key, default)``, so these, not the
    factory's own defaults, decide an unset key (``lars`` momentum 0,
    ``yogi`` eps 1e-8)."""

    type: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    amsgrad: bool = False
    eps: float = 1e-8
    betas: Optional[List[float]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "OptimizerConfig":
        if raw is None:
            return cls()
        return cls(**_take(dict(raw), ["type", "lr", "momentum", "nesterov",
                                       "weight_decay", "amsgrad", "eps",
                                       "betas"]))


@dataclass
class AnnealingConfig(Config):
    type: str = "step_lr"
    step_interval: str = "epoch"
    step_size: int = 1
    gamma: float = 1.0
    milestones: Optional[List[int]] = None
    patience: int = 10
    factor: float = 0.1
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "AnnealingConfig":
        if raw is None:
            return cls()
        return cls(**_take(dict(raw), [
            "type", "step_interval", "step_size", "gamma", "milestones",
            "patience", "factor"]))


@dataclass
class RLConfig(Config):
    """The RL weight hook's settings: the JAX package's ``RLConfig``
    (``msrflute_tpu/config.py:326-351``), fields and defaults."""

    marginal_update_RL: bool = True
    RL_path: Optional[str] = None
    RL_path_global: bool = True
    model_descriptor_RL: str = "marginalUpdate"
    network_params: Optional[List[int]] = None
    initial_epsilon: float = 0.5
    final_epsilon: float = 0.0001
    epsilon_gamma: float = 0.90
    max_replay_memory_size: int = 1000
    minibatch_size: int = 16
    gamma: float = 0.99
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    annealing_config: AnnealingConfig = field(default_factory=AnnealingConfig)
    wantLSTM: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> Optional["RLConfig"]:
        if raw is None:
            return None
        raw = dict(raw)
        opt = OptimizerConfig.from_dict(raw.pop("optimizer_config", None))
        ann = AnnealingConfig.from_dict(raw.pop("annealing_config", None))
        out = cls(**_take(raw, _RL_FIELDS))
        out.optimizer_config = opt
        out.annealing_config = ann
        return out


_RL_FIELDS = ["marginal_update_RL", "RL_path", "RL_path_global",
              "model_descriptor_RL", "network_params", "initial_epsilon",
              "final_epsilon", "epsilon_gamma", "max_replay_memory_size",
              "minibatch_size", "gamma", "wantLSTM"]


@dataclass
class DatasetConfig(Config):
    batch_size: int = 32
    list_of_train_data: Optional[str] = None
    test_data: Optional[str] = None
    val_data: Optional[str] = None
    train_data: Optional[str] = None
    desired_max_samples: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "DatasetConfig":
        if raw is None:
            return cls()
        return cls(**_take(dict(raw), [
            "batch_size", "list_of_train_data", "test_data", "val_data",
            "train_data", "desired_max_samples"]))


@dataclass
class DataConfig(Config):
    train: DatasetConfig = field(default_factory=DatasetConfig)
    val: DatasetConfig = field(default_factory=DatasetConfig)
    test: DatasetConfig = field(default_factory=DatasetConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "DataConfig":
        raw = dict(raw or {})
        return cls(train=DatasetConfig.from_dict(raw.pop("train", None)),
                   val=DatasetConfig.from_dict(raw.pop("val", None)),
                   test=DatasetConfig.from_dict(raw.pop("test", None)),
                   extra=raw)


@dataclass
class ModelConfig(Config):
    model_type: str = "LR"
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "ModelConfig":
        if raw is None:
            return cls()
        return cls(**_take(dict(raw), ["model_type"]))


@dataclass
class ServerConfig(Config):
    type: str = "optimization"
    max_iteration: int = 100
    num_clients_per_iteration: Any = 10   # int or "lo:hi"
    initial_lr_client: float = 0.01
    lr_decay_factor: float = 1.0
    val_freq: int = 20
    rec_freq: int = 20
    initial_val: bool = True
    initial_rec: bool = False
    best_model_criterion: str = "loss"
    fall_back_to_best_model: bool = False
    model_backup_freq: int = 100
    resume_from_checkpoint: bool = False
    max_grad_norm: Optional[float] = None
    rounds_per_step: int = 1
    megakernel: Optional[Dict[str, Any]] = None
    RL: Optional[RLConfig] = None
    data_config: DataConfig = field(default_factory=DataConfig)
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    annealing_config: AnnealingConfig = field(default_factory=AnnealingConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "ServerConfig":
        raw = dict(raw or {})
        rl = RLConfig.from_dict(raw.pop("RL", None))
        data = DataConfig.from_dict(raw.pop("data_config", None))
        opt = OptimizerConfig.from_dict(raw.pop("optimizer_config", None))
        ann = AnnealingConfig.from_dict(raw.pop("annealing_config", None))
        out = cls(**_take(raw, [
            "type", "max_iteration", "num_clients_per_iteration",
            "initial_lr_client", "lr_decay_factor", "val_freq", "rec_freq",
            "initial_val", "initial_rec", "best_model_criterion",
            "fall_back_to_best_model", "model_backup_freq",
            "resume_from_checkpoint", "max_grad_norm", "rounds_per_step",
            "megakernel"]))
        out.data_config = data
        out.optimizer_config = opt
        out.annealing_config = ann
        out.RL = rl
        return out


@dataclass
class ClientConfig(Config):
    type: str = "optimization"
    desired_max_samples: Optional[int] = None
    max_grad_norm: Optional[float] = None
    fedprox_mu: float = 0.0
    num_epochs: int = 1
    step_bucketing: bool = True
    data_config: DataConfig = field(default_factory=DataConfig)
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "ClientConfig":
        raw = dict(raw or {})
        data = DataConfig.from_dict(raw.pop("data_config", None))
        opt = OptimizerConfig.from_dict(raw.pop("optimizer_config", None))
        out = cls(**_take(raw, [
            "type", "desired_max_samples", "max_grad_norm", "fedprox_mu",
            "num_epochs", "step_bucketing"]))
        out.data_config = data
        out.optimizer_config = opt
        return out


@dataclass
class PrivacyMetricsConfig(Config):
    """Privacy-attack metric settings, with the JAX package's defaults
    (``msrflute_tpu/config.py::PrivacyMetricsConfig``): an absent
    ``attacker_optimizer_config`` is ``OptimizerConfig()``, plain SGD at
    0.01, as there."""

    apply_metrics: bool = False
    apply_indices_extraction: bool = False
    allowed_word_rank: int = 9000
    apply_leakage_metric: bool = False
    max_leakage: float = 30.0
    max_allowed_leakage: float = 3.0
    adaptive_leakage_threshold: float = 0.0
    is_leakage_weighted: bool = False
    attacker_optimizer_config: OptimizerConfig = field(
        default_factory=OptimizerConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]
                  ) -> "PrivacyMetricsConfig":
        raw = dict(raw or {})
        att = OptimizerConfig.from_dict(raw.pop("attacker_optimizer_config",
                                                None))
        out = cls(**_take(raw, [
            "apply_metrics", "apply_indices_extraction", "allowed_word_rank",
            "apply_leakage_metric", "max_leakage", "max_allowed_leakage",
            "adaptive_leakage_threshold", "is_leakage_weighted"]))
        out.attacker_optimizer_config = att
        return out


@dataclass
class FLUTEConfig(Config):
    model_config: ModelConfig = field(default_factory=ModelConfig)
    strategy: str = "fedavg"
    #: ``dp_config`` as written (DGA, FedAvg / FedProx and secure_agg; see
    #: :func:`validate`)
    dp_config: Optional[Dict[str, Any]] = None
    #: ``None`` unless ``privacy_metrics_config.apply_metrics`` is on
    privacy_metrics_config: Optional[PrivacyMetricsConfig] = None
    server_config: ServerConfig = field(default_factory=ServerConfig)
    client_config: ClientConfig = field(default_factory=ClientConfig)
    task: Optional[str] = None
    data_path: Optional[str] = None
    output_path: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "FLUTEConfig":
        raw = copy.deepcopy(raw)
        validate(raw)
        for key in ("mesh_config", "experiment"):
            raw.pop(key, None)   # validate() proved them inert
        pm = raw.pop("privacy_metrics_config", None)
        return cls(
            model_config=ModelConfig.from_dict(raw.pop("model_config", None)),
            strategy=raw.pop("strategy", "fedavg"),
            dp_config=raw.pop("dp_config", None),
            privacy_metrics_config=(PrivacyMetricsConfig.from_dict(pm)
                                    if pm and pm.get("apply_metrics")
                                    else None),
            server_config=ServerConfig.from_dict(raw.pop("server_config",
                                                         None)),
            client_config=ClientConfig.from_dict(raw.pop("client_config",
                                                         None)),
            task=raw.pop("task", None),
            data_path=raw.pop("data_path", None),
            output_path=raw.pop("output_path", None),
            extra=raw)

    @classmethod
    def from_yaml(cls, path: str) -> "FLUTEConfig":
        with open(path, "r") as fh:
            return cls.from_dict(yaml.safe_load(fh))

    def validate(self, data_path: Optional[str] = None) -> "FLUTEConfig":
        """Join ``data_path`` onto the per-split file names (reference
        ``core/config.py:736-760``)."""
        data_path = data_path or self.data_path
        if data_path:
            for section in (self.server_config.data_config,
                            self.client_config.data_config):
                for split in (section.train, section.val, section.test):
                    for attr in ("list_of_train_data", "test_data",
                                 "val_data", "train_data"):
                        val = getattr(split, attr)
                        if val and not os.path.isabs(val):
                            setattr(split, attr, os.path.join(data_path, val))
                    for key in ("vocab_dict", "train_data_server"):
                        val = split.get(key)
                        if val and not os.path.isabs(val):
                            split[key] = os.path.join(data_path, val)
            vocab = self.model_config.get("vocab_dict")
            if vocab and not os.path.isabs(vocab):
                self.model_config["vocab_dict"] = os.path.join(data_path,
                                                               vocab)
        return self


def parse_clients_per_round(spec: Any, rng) -> int:
    """``num_clients_per_iteration``: an int, or ``"lo:hi"`` meaning a
    per-round uniform random count (reference ``core/server.py:284-291``)."""
    if isinstance(spec, int):
        return spec
    if isinstance(spec, str) and ":" in spec:
        lo, hi = (int(x) for x in spec.split(":"))
        return int(rng.integers(lo, hi + 1))
    return int(spec)


def cohort_upper_bound(spec: Any) -> int:
    """The largest cohort ``num_clients_per_iteration`` can draw: the
    rng-free companion of :func:`parse_clients_per_round`, which sizes the
    bucket capacities (``msrflute_tpu/config.py:591-598``)."""
    if isinstance(spec, str) and ":" in spec:
        return int(spec.split(":")[1])
    return int(spec)


# ----------------------------------------------------------------------
# validation of the ported slices
# ----------------------------------------------------------------------
#: keys each section runs in the port
_TOP = {"model_config", "strategy", "server_config", "client_config", "task",
        "data_path", "output_path"}
_SERVER = {"type", "max_iteration", "num_clients_per_iteration",
           "initial_lr_client", "lr_decay_factor", "val_freq", "rec_freq",
           "initial_val", "initial_rec", "best_model_criterion",
           "fall_back_to_best_model", "model_backup_freq",
           "resume_from_checkpoint", "max_grad_norm", "rounds_per_step",
           "megakernel", "data_config", "optimizer_config",
           "annealing_config", "personalization_init",
           "personalization_interp", "semisupervision", "precision",
           "server_replay_config", "pipeline_depth", "input_staging",
           "checkpoint_async", "checkpoint_retry", "clients_per_chunk",
           "dump_norm_stats", "cohort_bucketing", "megabatch",
           # a torch.profiler trace of one chunk (engine/server.py), the
           # arrival plane and fleet sampling, checked by check_parity
           "do_profiling", "traffic", "fleet"}
#: ``server_config.checkpoint_retry`` (``msrflute_tpu/schema.py``
#: ``CHECKPOINT_RETRY_FIELD_SPECS``): ``(kind, min, max)`` a key
CHECKPOINT_RETRY_SPECS = {
    "retries": ("int", 1, None),
    "backoff_base_s": ("num", 0, None),
    "backoff_max_s": ("num", 0, None),
    "jitter": ("num", 0, 1.0),
    "escalation_threshold": ("int", 1, None),
}
_CLIENT = {"type", "desired_max_samples", "max_grad_norm", "fedprox_mu",
           "num_epochs", "step_bucketing", "data_config", "optimizer_config",
           "convex_model_interp", "semisupervision", "freeze_layer",
           "do_profiling"}
#: ``max_num_words`` of a data split is inert: the sequence length comes
#: from ``model_config.max_num_words``, as in the JAX package
_DATASET = {"batch_size", "list_of_train_data", "test_data", "val_data",
            "train_data", "desired_max_samples", "vocab_dict",
            "max_num_words", "augment", "train_data_server",
            # the eval outputs of a val / test split (engine/server.py)
            "wantLogits", "per_user_stats",
            # the data planes, read from client_config.data_config.train
            # (engine/server.py): the device-resident sample pool and
            # length bucketing; lazy users (tasks.py)
            "device_resident", "length_bucketing", "lazy",
            "lazy_cache_users"}
#: each optimizer type's keys (``msrflute_tpu/optim/factory.py`` reads no
#: other).  adam's ``amsgrad`` is accepted and not applied, as the JAX
#: package builds ``optax.adam`` whatever it says; the JAX package gives
#: adamW and adamax optax's default betas whatever ``betas`` says.  Any
#: other optimizer key raises unless off.
_SGD = {"type", "lr", "momentum", "nesterov", "weight_decay"}
_ADAM = {"type", "lr", "eps", "betas", "amsgrad"}
_OPTIMIZER_KEYS = {
    "sgd": _SGD, "adam": _ADAM, "adamax": _ADAM,
    "adamw": _ADAM | {"weight_decay"},
    "lamb": {"type", "lr", "weight_decay"},
    "lars": {"type", "lr", "momentum", "weight_decay"},
    "larssgd": {"type", "lr", "momentum", "weight_decay"},
    "yogi": {"type", "lr", "betas", "eps", "weight_decay"},
}
#: ``server_config.precision`` (``msrflute_tpu/schema.py:306-312``): each
#: entry a dtype name, float32 (absent) the bit-identical default
_PRECISION = {"enable", "params", "compute", "stats"}
_PRECISION_DTYPES = ("float32", "bfloat16", "float16")
#: ``model_config.dtype`` spellings (``msrflute_tpu/models/base.py:78-92``)
DTYPE_NAMES = {"float32": "float32", "f32": "float32",
               "bfloat16": "bfloat16", "bf16": "bfloat16",
               "float16": "float16", "f16": "float16"}
#: the models whose JAX modules read ``model_config.dtype``
#: (``parse_dtype``) and whose port casts each layer to it; the precision
#: policy's ``params`` and ``compute`` need these casts too.  GRU, ECG_CNN,
#: NRMS and plugins never call ``parse_dtype``: their ``dtype`` is
#: accepted and ignored, as in the JAX package
DTYPE_MODELS = {"LR", "CNN", "CNN_FEMNIST", "CIFAR_CNN", "RESNET", "ResNet",
                "RNN", "LSTM", "RINGLM"}
#: ``server_config.server_replay_config`` (``msrflute_tpu/engine/
#: server.py:629-646``; ``updatable_names`` is what its replay reads)
_REPLAY = {"server_iterations", "optimizer_config", "updatable_names"}
#: ``privacy_metrics_config`` (``msrflute_tpu/schema.py``
#: ``PRIVACY_METRICS_KEYS``)
_PRIVACY_METRICS = {"apply_metrics", "apply_indices_extraction",
                    "allowed_word_rank", "apply_leakage_metric",
                    "max_leakage", "max_allowed_leakage",
                    "adaptive_leakage_threshold", "is_leakage_weighted",
                    "attacker_optimizer_config", "max_allowed_overlap"}
_ANNEALING = {"type", "step_interval", "step_size", "gamma", "milestones",
              "patience", "factor", "peak_lr", "floor_lr", "rampup_steps",
              "hold_steps", "decay_steps"}
_ANNEALING_TYPES = ("step_lr", "multi_step_lr", "val_loss", "constant",
                    "rampup-keep-expdecay-keep")
_MEGAKERNEL = {"enable", "fused_epochs", "pallas_apply"}
#: ``strategy: dga`` runs these besides the keys above
_DGA_SERVER = {"aggregate_median", "softmax_beta", "weight_train_loss",
               "stale_prob"}
_DGA_CLIENT = {"quant_thresh", "quant_threshold", "quant_bits",
               "quant_approx", "quant_anneal"}
#: ``strategy: ef_quant``'s client keys (``strategies/ef_quant.py``)
_EF_CLIENT = {"quant_thresh", "quant_bits", "quant_approx", "quant_anneal"}
#: the later strategies' server keys, and the RL hook's; each strategy
#: reads its own and ignores the others', as in the JAX package
_STRATEGY_SERVER = {"wantRL", "RL", "qffl_q", "fedac_eta", "fedac_gamma",
                    "fedac_alpha", "fedac_beta", "fedbuff",
                    "scaffold_device_controls", "scaffold_flush_freq",
                    "ef_device_residuals", "ef_flush_freq", "fused_carry"}
_RL = set(_RL_FIELDS) | {"optimizer_config", "annealing_config"}
#: ``semisupervision`` (FedLabels, read from the client section, then the
#: server's); ``comp`` names the pseudo-label comparison, of which the JAX
#: package runs ``var`` whatever it says, so the port accepts only that
_SEMISUP = {"eta", "burnout_round", "unsuptrain_ep", "temp", "thre", "comp",
            "vat_consis", "l2_lambda", "unsup_lamb", "uda"}
#: ``data_config.<split>.augment``: RandAugment on the train split
_AUGMENT = {"type", "num_ops", "magnitude", "seed"}
_SERVER_TYPES = ("optimization", "model_optimization", "personalization")
_DP = {"enable_local_dp", "enable_global_dp", "eps", "delta", "max_grad",
       "max_weight", "min_weight", "weight_scaler", "global_sigma",
       "adaptive_clipping"}
#: ``dp_config.adaptive_clipping`` (``msrflute_tpu/schema.py``
#: ``ADAPTIVE_CLIP_KEYS``)
_ADAPTIVE_CLIP = {"target_quantile", "clip_lr", "initial_clip",
                  "count_sigma"}
#: the strategies that read dp_config (DGA's DP; FedAvg / FedProx's local
#: DP and adaptive clipping; FedAC, FedBuff and EF's local DP through
#: FedAvg's client step; FedLabels, whose client step reads none of it;
#: secure_agg, which refuses both DP modes); q-FFL and SCAFFOLD refuse it
#: with ``ValueError`` (:func:`check_strategy`)
_DP_STRATEGIES = {"dga", "fedavg", "fedprox", "fedac", "fedbuff",
                  "ef_quant", "efquant", "fedlabels", "secure_agg", "secagg",
                  "secureagg"}
_SECURE_AGG_NAMES = ("secure_agg", "secagg", "secureagg")
#: ``server_config.chaos`` (``CHAOS_KEYS``)
_CHAOS = {"enable", "seed", "dropout_rate", "straggler_rate",
          "straggler_inflation", "ckpt_io_error_rate", "preempt_at_round",
          "corrupt_nan_rate", "corrupt_scale_rate", "corrupt_sign_flip_rate",
          "corrupt_scale_factor", "corrupt_sign_flip_scale", "infra"}
_CHAOS_INFRA = {"store_write_error_rate", "store_read_error_rate",
                "prefetch_error_rate", "prefetch_delay_rate",
                "prefetch_delay_s", "writer_error_rate",
                "writeback_error_rate"}
#: ``server_config.robust`` (``ROBUST_KEYS``)
_ROBUST = {"enable", "screen_nonfinite", "norm_multiplier", "aggregator",
           "trim_fraction"}
#: the server keys of this slice's defenses, checked by
#: :func:`check_defense`
_DEFENSE_SERVER = {"chaos", "robust", "secure_agg", "telemetry"}

#: keys that tune how the JAX package dispatches its TPU program and change
#: no result, which the port ignores.
#: (``client_config.annealing_config`` is here because the JAX package
#: reads no client schedule at all, and ``client_config.updatable_layers``
#: because its round never passes it into ``ClientHParams``,
#: ``msrflute_tpu/engine/round.py:150-204``: only server replay's
#: ``updatable_names`` reaches a client update.)
_DISPATCH_ONLY = {
    "server_config": {"compilation_cache_dir"},
    "dataset": {"loader_type", "pin_memory", "num_workers",
                "prefetch_factor"},
    "client_config": {"annealing_config", "updatable_layers"},
}

#: keys that the JAX config parses, or its schema accepts, and nothing in
#: the JAX package reads (``msrflute_tpu/config.py:200-201, 450-453,
#: 497-503``; ``schema.py:75, 89-91, 103, 466, 547, 558``): accepted and
#: ignored, as there, once their types pass the JAX schema's checks
#: (:data:`_INERT_SPECS`).  The dataset's ``max_grad_norm`` is read only
#: at the server and client level.
_INERT = {
    "server_config": {"send_dicts", "initial_lr", "num_skip_decoding",
                      "nbest_task_scheduler", "best_model_metric",
                      "updatable_names"},
    "client_config": {"meta_learning", "copying_train_data",
                      "ignore_subtask", "num_skip_decoding",
                      "meta_optimizer_config", "ss_config"},
    "dataset": {"max_batch_size", "min_words_per_utt", "max_seq_length",
                "num_frames", "max_samples_per_user", "max_grad_norm",
                "utterance_mvn", "unsorted_batch"},
    "optimizer": {"dampening"},
    "dp": {"enable_prod", "max_bound", "min_bound"},
}
#: the JAX schema's type rules of the inert keys, the eval outputs and the
#: data planes' keys (``msrflute_tpu/schema.py:583-681``)
_INERT_SPECS = {
    "server_config": {"send_dicts": ("bool", None, None),
                      "initial_lr": ("num", 0, None)},
    "client_config": {"copying_train_data": ("bool", None, None),
                      "ignore_subtask": ("bool", None, None)},
    "dataset": {"wantLogits": ("bool", None, None),
                "per_user_stats": ("bool", None, None),
                # the data planes (``schema.py:637, 643``)
                "device_resident": ("bool", None, None),
                "length_bucketing": ("bool", None, None),
                "lazy": ("bool", None, None),
                "lazy_cache_users": ("int", 1, None),
                "max_seq_length": ("int", 1, None),
                "max_samples_per_user": ("int", 1, None),
                "unsorted_batch": ("bool", None, None)},
    "optimizer": {"dampening": ("num", 0, 1.0)},
    "dp": {"enable_prod": ("bool", None, None)},
}

#: every other key the JAX package's schema knows (``msrflute_tpu/schema.py``
#: ``SERVER_KEYS``, ``CLIENT_KEYS``, ``DATASET_KEYS``, ``OPTIMIZER_KEYS``,
#: ``ANNEALING_KEYS``, ``DP_KEYS``, ``TOP_KEYS``): a feature the port does
#: not have yet.  It may appear with its "off" value (False, 0, None, empty,
#: a block with ``enable: false``); any other value raises
#: ``NotImplementedError``
_OFF_OK = {
    "server_config": {"checkpoint_backend"} | _DGA_SERVER,
    "client_config": _DGA_CLIENT,
    "dataset": {"step_bucketing"},
    "optimizer": {"amsgrad", "eps", "betas", "momentum", "nesterov",
                  "weight_decay"},
    "replay": {"data_config"},
    "dp": set(),
    "top": {"dp_config", "mesh_config", "experiment"},
}

_STRATEGIES_PORTED = {"fedavg", "fedprox", "dga", "fedlabels", "qffl",
                      "fedac", "fedbuff", "scaffold", "ef_quant", "efquant",
                      "secure_agg", "secagg", "secureagg"}
_MODELS_PORTED = {"LR", "CNN", "CNN_FEMNIST", "CIFAR_CNN", "RESNET",
                  "ResNet", "RNN", "LSTM", "GRU", "RINGLM", "ECG_CNN",
                  "NRMS", "FEDNEWSREC", "BERT"}
#: ResNet depths and their stages (``msrflute_tpu/models/resnet.py``)
RESNET_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def _off(key: str, value: Any) -> bool:
    """Whether a JAX-feature key carries a value that leaves the feature
    off (the port's behavior)."""
    if key == "checkpoint_backend":
        return value in (None, "msgpack")
    if key == "aggregate_median":
        return value in (None, "softmax")   # FedAvg never reads it
    if key == "dp_config" and isinstance(value, dict):
        return not (value.get("enable_local_dp") or
                    value.get("enable_global_dp"))
    if key == "mesh_config" and isinstance(value, dict):
        return int(value.get("model_axis_size", 1) or 1) == 1
    if key == "experiment":
        return True   # free-form run metadata
    if isinstance(value, dict) and "enable" in value:
        return not value["enable"]
    return not value


def _check_keys(raw: Any, path: str, known: set, off_ok: set = frozenset(),
                ignored: set = frozenset()) -> None:
    if raw is None:
        return
    if not isinstance(raw, dict):
        raise ValueError(f"{path} must be a mapping, got {type(raw).__name__}")
    for key, value in raw.items():
        if key in known or key in ignored:
            continue
        if key in off_ok:
            if _off(key, value):
                continue
            raise NotImplementedError(f"{path}.{key}={value!r} is {NOT_PORTED}")
        raise ValueError(f"unknown config key {path}.{key}")


def validate(raw: Dict[str, Any]) -> None:
    """Refuse any config the ported slices cannot run as the JAX package
    would (see the module docstring)."""
    if not isinstance(raw, dict):
        raise ValueError("config must be a mapping")
    strategy = str(raw.get("strategy", "fedavg")).lower()
    if strategy not in _STRATEGIES_PORTED:
        raise NotImplementedError(f"strategy {strategy!r} is {NOT_PORTED}")
    check_strategy(raw, strategy)
    check_defense(raw, strategy)
    dga = strategy == "dga"
    ef = strategy in ("ef_quant", "efquant")
    # quantization is ported inside DGA only, DP inside DGA, FedAvg /
    # FedProx and secure_agg; under the other strategies they keep raising
    # unless off
    dp_ok = strategy in _DP_STRATEGIES
    top_off = _OFF_OK["top"] - ({"dp_config"} if dp_ok else set())
    check_mesh(raw.get("mesh_config"))
    _check_keys(raw, "config",
                _TOP | {"privacy_metrics_config"}
                | ({"dp_config"} if dp_ok else set()), off_ok=top_off)
    pm = raw.get("privacy_metrics_config")
    _check_keys(pm, "privacy_metrics_config", _PRIVACY_METRICS)
    if pm and pm.get("apply_metrics"):
        _check_optimizer(pm.get("attacker_optimizer_config"),
                         "privacy_metrics_config.attacker_optimizer_config")
    if dp_ok:
        dp = raw.get("dp_config")
        _check_keys(dp, "dp_config", _DP, off_ok=_OFF_OK["dp"],
                    ignored=_INERT["dp"])
        _check_keys((dp or {}).get("adaptive_clipping"),
                    "dp_config.adaptive_clipping", _ADAPTIVE_CLIP)
    model = dict(raw.get("model_config") or {})
    mtype = model.get("model_type", "LR")
    folder = model.get("model_folder")
    if folder is not None and not isinstance(folder, str):
        raise ValueError("model_config.model_folder must be a path, got "
                         f"{folder!r}")
    # a plugin's model_type names its folder's task; models/registry.py
    # finds the port's twin of it or raises
    if not folder and mtype not in _MODELS_PORTED:
        raise NotImplementedError(f"model_type {mtype!r} is {NOT_PORTED}")
    model_dtype(model)   # a known spelling, else ValueError
    if mtype == "RINGLM":
        check_ringlm_model(model)
    if mtype == "BERT":
        check_bert_model(model)
    if mtype in ("NRMS", "FEDNEWSREC") and \
            str(model.get("arch", "nrms")) not in ("nrms", "fednewsrec"):
        raise ValueError("model_config.arch must be 'nrms' or 'fednewsrec', "
                         f"got {model['arch']!r}")
    if mtype in ("RESNET", "ResNet") and \
            int(model.get("depth", 18)) not in RESNET_DEPTHS:
        raise ValueError(f"model_config.depth={model['depth']!r}: ResNet "
                         f"depths are {sorted(RESNET_DEPTHS)}")
    if not dga:
        for key in ("quant_threshold", "quant_bits"):
            if model.get(key) is not None:
                raise NotImplementedError(
                    f"model_config.{key} outside strategy dga is "
                    f"{NOT_PORTED}")

    sc = raw.get("server_config") or {}
    _check_keys(sc, "server_config",
                _SERVER | _STRATEGY_SERVER | _DEFENSE_SERVER
                | (_DGA_SERVER if dga else set()),
                off_ok=_OFF_OK["server_config"],
                ignored=_DISPATCH_ONLY["server_config"]
                | _INERT["server_config"])
    check_dispatch(sc)
    check_throughput(sc, strategy)
    check_inert(raw)
    check_parity(raw, strategy)
    check_telemetry(sc.get("telemetry"))
    _check_keys(sc.get("checkpoint_retry"), "server_config.checkpoint_retry",
                set(CHECKPOINT_RETRY_SPECS))
    rl = sc.get("RL")
    _check_keys(rl, "server_config.RL", _RL)
    if rl:
        _check_optimizer(rl.get("optimizer_config"),
                         "server_config.RL.optimizer_config")
        _check_keys(rl.get("annealing_config"),
                    "server_config.RL.annealing_config", _ANNEALING)
    if str(sc.get("type", "optimization")) not in _SERVER_TYPES:
        raise NotImplementedError(
            f"server_config.type={sc.get('type')!r} is {NOT_PORTED}")
    for key, allowed in (("personalization_init",
                          ("global", "initial", "random")),
                         ("personalization_interp", ("probs", "logprobs"))):
        if sc.get(key) is not None and sc[key] not in allowed:
            raise ValueError(f"server_config.{key}={sc[key]!r}: one of "
                             f"{list(allowed)}")
    mk = sc.get("megakernel") or {}
    _check_keys(mk, "server_config.megakernel", _MEGAKERNEL)
    check_precision(sc.get("precision"), mtype if not folder else None)
    replay = sc.get("server_replay_config")
    _check_keys(replay, "server_config.server_replay_config", _REPLAY,
                off_ok=_OFF_OK["replay"])
    if replay:
        _check_optimizer(replay.get("optimizer_config"),
                         "server_config.server_replay_config."
                         "optimizer_config")
        names = replay.get("updatable_names")
        if names is not None and not (
                isinstance(names, (list, tuple)) and
                all(isinstance(n, str) for n in names)):
            raise ValueError("server_config.server_replay_config."
                             "updatable_names must be a list of patterns, "
                             f"got {names!r}")
    cc = raw.get("client_config") or {}
    _check_keys(cc, "client_config",
                _CLIENT | (_DGA_CLIENT if dga else _EF_CLIENT if ef
                           else set()),
                off_ok=_OFF_OK["client_config"],
                ignored=_DISPATCH_ONLY["client_config"]
                | _INERT["client_config"])
    freeze = cc.get("freeze_layer")
    if freeze is not None and not isinstance(freeze, str) and not (
            isinstance(freeze, (list, tuple)) and
            all(isinstance(f, str) for f in freeze)):
        raise ValueError("client_config.freeze_layer must be a name or a "
                         f"list of names, got {freeze!r}")
    if str(cc.get("type", "optimization")) != "optimization":
        raise NotImplementedError(
            f"client_config.type={cc.get('type')!r} is {NOT_PORTED}")
    interp = cc.get("convex_model_interp")
    if interp is not None and not 0.0 <= float(interp) <= 1.0:
        raise ValueError(f"client_config.convex_model_interp={interp!r} "
                         "is outside [0, 1]")
    for path, section in (("client_config", cc), ("server_config", sc)):
        ss = section.get("semisupervision")
        _check_keys(ss, f"{path}.semisupervision", _SEMISUP)
        if ss and str(ss.get("comp", "var")) != "var":
            raise NotImplementedError(
                f"{path}.semisupervision.comp={ss['comp']!r} is "
                f"{NOT_PORTED}")
    for path, section in (("server_config", sc), ("client_config", cc)):
        dc = section.get("data_config") or {}
        _check_keys(dc, f"{path}.data_config", {"train", "val", "test"})
        for split in ("train", "val", "test"):
            _check_keys(dc.get(split), f"{path}.data_config.{split}",
                        _DATASET, off_ok=_OFF_OK["dataset"],
                        ignored=_DISPATCH_ONLY["dataset"]
                        | _INERT["dataset"])
            aug = (dc.get(split) or {}).get("augment")
            _check_keys(aug, f"{path}.data_config.{split}.augment", _AUGMENT)
            if aug and str(aug.get("type", "randaugment")) != "randaugment":
                raise NotImplementedError(
                    f"{path}.data_config.{split}.augment.type="
                    f"{aug['type']!r} is {NOT_PORTED}")
        _check_optimizer(section.get("optimizer_config"),
                         f"{path}.optimizer_config")
    ann = sc.get("annealing_config")
    _check_keys(ann, "server_config.annealing_config", _ANNEALING)
    if ann and ann.get("type", "step_lr") not in _ANNEALING_TYPES:
        raise ValueError(f"annealing type {ann.get('type')!r}: one of "
                         f"{list(_ANNEALING_TYPES)}")


#: the most chunks the dispatch ring holds (``msrflute_tpu/schema.py:405-411``)
MAX_PIPELINE_DEPTH = 8


class SchemaError(ValueError):
    """The JAX schema's error: every violation, one a line."""

    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("config schema violations:\n  "
                         + "\n  ".join(errors))


def _check_fields(errors: List[str], raw: Any, path: str,
                  specs: Dict[str, tuple]) -> None:
    """Type and inclusive-range checks of ``raw``'s keys, in the JAX
    schema's words (``schema.py:713-745``); a ``None`` value skips."""
    if not isinstance(raw, dict):
        return
    for key, (kind, lo, hi) in specs.items():
        val = raw.get(key)
        if val is None:
            continue
        if kind == "bool":
            if not isinstance(val, bool):
                errors.append(f"{path}.{key}: must be a boolean, got "
                              f"{type(val).__name__}")
            continue
        if isinstance(val, bool) or not isinstance(
                val, int if kind == "int" else (int, float)):
            want = "an integer" if kind == "int" else "a number"
            errors.append(f"{path}.{key}: must be {want}, got "
                          f"{type(val).__name__}")
            continue
        if val != val:
            errors.append(f"{path}.{key}: must be a finite number, got NaN")
            continue
        if lo is not None and val < lo:
            errors.append(f"{path}.{key}: must be >= {lo}, got {val}")
        if hi is not None and val > hi:
            errors.append(f"{path}.{key}: must be <= {hi}, got {val}")


def check_inert(raw: Dict[str, Any]) -> None:
    """The types of the inert keys, of the eval outputs and of the data
    planes' keys, with the JAX schema's messages (:data:`_INERT_SPECS`)."""
    errors: List[str] = []
    sc = raw.get("server_config") or {}
    cc = raw.get("client_config") or {}
    _check_fields(errors, sc, "server_config",
                  _INERT_SPECS["server_config"])
    _check_fields(errors, cc, "client_config",
                  _INERT_SPECS["client_config"])
    _check_fields(errors, raw.get("dp_config"), "dp_config",
                  _INERT_SPECS["dp"])
    for path, section in (("server_config", sc), ("client_config", cc)):
        dc = section.get("data_config") or {}
        for split in ("train", "val", "test"):
            _check_fields(errors, dc.get(split),
                          f"{path}.data_config.{split}",
                          _INERT_SPECS["dataset"])
    if errors:
        raise SchemaError(errors)


def check_dispatch(sc: Dict[str, Any]) -> None:
    """The round loop's knobs, with the JAX schema's messages
    (``schema.py:443-448, 598-603, 713-745, 1130-1135, 1181-1192``):
    ``pipeline_depth`` an integer in ``[0, MAX_PIPELINE_DEPTH]``,
    ``rounds_per_step`` and ``clients_per_chunk`` ones >= 1,
    ``input_staging``, ``checkpoint_async``, ``fused_carry`` and
    ``dump_norm_stats`` booleans, ``checkpoint_retry``'s fields and chaos's
    ``preempt_at_round`` and ``ckpt_io_error_rate``."""
    errors = []
    _check_fields(errors, sc, "server_config", {
        "clients_per_chunk": ("int", 1, None),
        "dump_norm_stats": ("bool", None, None)})
    _check_fields(errors, sc.get("checkpoint_retry"),
                  "server_config.checkpoint_retry", CHECKPOINT_RETRY_SPECS)
    _check_fields(errors, sc.get("chaos"), "server_config.chaos", {
        "ckpt_io_error_rate": ("num", 0.0, 1.0),
        "preempt_at_round": ("int", 0, None)})
    for key, lo in (("pipeline_depth", 0), ("rounds_per_step", 1)):
        val = sc.get(key)
        if val is None:
            continue
        if isinstance(val, bool) or not isinstance(val, int):
            errors.append(f"server_config.{key}: must be an integer, got "
                          f"{type(val).__name__}")
        elif val < lo:
            errors.append(f"server_config.{key}: must be >= {lo}, got {val}")
    for key in ("input_staging", "checkpoint_async", "fused_carry"):
        val = sc.get(key)
        if val is not None and not isinstance(val, bool):
            errors.append(f"server_config.{key}: must be a boolean, got "
                          f"{type(val).__name__}")
    pd = sc.get("pipeline_depth")
    if isinstance(pd, int) and not isinstance(pd, bool) and \
            pd > MAX_PIPELINE_DEPTH:
        errors.append(
            f"server_config.pipeline_depth: {pd} exceeds the supported "
            f"maximum {MAX_PIPELINE_DEPTH} — each depth slot keeps a full "
            "round chunk's staged inputs and packed stats resident in "
            "device memory, and depth past the host-tail/device-round "
            "ratio buys nothing; lower it (see docs/RUNBOOK.md pipeline "
            "tuning)")
    if errors:
        raise SchemaError(errors)


#: ``server_config.cohort_bucketing`` and ``megabatch``, with the JAX
#: schema's field rules (``msrflute_tpu/schema.py:160-205``)
COHORT_BUCKETING_SPECS = {"enable": ("bool", None, None),
                          "max_buckets": ("int", 1, None),
                          "slack": ("num", 1.0, None)}
MEGABATCH_SPECS = {"enable": ("bool", None, None),
                   "lanes": ("int", 1, None),
                   "slack": ("num", 1.0, None),
                   "min_gain": ("num", 0.0, None),
                   "autotune": ("bool", None, None)}


#: ``server_config.fleet`` and ``traffic``, with the JAX schema's field
#: rules (``msrflute_tpu/schema.py:205-303``)
FLEET_SPECS = {"enable": ("bool", None, None),
               "page_pool_slots": ("int", 1, None),
               "host_cache_rows": ("int", 1, None),
               "spill_freq": ("int", 1, None),
               "prefetch": ("bool", None, None)}
FLEET_SAMPLING = ("uniform", "floyd", "by_samples")
TRAFFIC_SPECS = {"enable": ("bool", None, None),
                 "seed": ("int", None, None),
                 "buffer_size": ("int", 1, None),
                 "duration_lo": ("int", 1, None),
                 "duration_hi": ("int", 1, None),
                 "max_idle_ticks": ("int", 1, None),
                 "target_accuracy": ("num", 0.0, 1.0),
                 "rate": ("num", 0.0, None),
                 "period": ("int", 1, None),
                 "depth": ("num", 0.0, None),
                 "burst_rate": ("num", 0.0, None),
                 "burst_every": ("int", 1, None),
                 "burst_len": ("int", 1, None)}
TRAFFIC_MODES = ("sync", "buffered")
TRAFFIC_TRACES = ("poisson", "diurnal", "bursty", "device_classes")


def check_parity(raw: Dict[str, Any], strategy: str) -> None:
    """``do_profiling``, ``fleet`` and ``traffic`` as the JAX schema checks
    them (``schema.py:1008-1111``): booleans, the blocks' keys, field
    types and enums, ``duration_hi >= duration_lo``, ``classes`` a list of
    mappings, and secure aggregation's ``min_survivors`` no larger than the
    buffer.  ``fleet`` beside a device-carry strategy is the paged carry
    (:mod:`.engine.paging`)."""
    errors: List[str] = []
    sc = raw.get("server_config") or {}
    cc = raw.get("client_config") or {}
    _check_fields(errors, sc, "server_config",
                  {"do_profiling": ("bool", None, None)})
    _check_fields(errors, cc, "client_config",
                  {"do_profiling": ("bool", None, None)})
    for name, specs in (("fleet", FLEET_SPECS), ("traffic", TRAFFIC_SPECS)):
        blk = sc.get(name)
        if blk is not None and not isinstance(blk, dict):
            errors.append(f"server_config.{name}: must be a mapping (see "
                          "docs/config_extensions.md), got "
                          f"{type(blk).__name__}")
        elif blk:
            keys = set(specs) | ({"sampling"} if name == "fleet" else
                                 {"mode", "trace", "classes"})
            _check_keys(blk, f"server_config.{name}", keys)
            _check_fields(errors, blk, f"server_config.{name}", specs)
    fl, tr = sc.get("fleet"), sc.get("traffic")
    for blk, name, key, allowed in (
            (fl, "fleet", "sampling", FLEET_SAMPLING),
            (tr, "traffic", "mode", TRAFFIC_MODES),
            (tr, "traffic", "trace", TRAFFIC_TRACES)):
        val = blk.get(key) if isinstance(blk, dict) else None
        if val is not None and val not in allowed:
            errors.append(f"server_config.{name}.{key}: {val!r} not in "
                          f"{list(allowed)}")
    if isinstance(tr, dict):
        lo, hi = tr.get("duration_lo"), tr.get("duration_hi")
        if isinstance(lo, int) and isinstance(hi, int) and hi < lo:
            errors.append(f"server_config.traffic: duration_hi ({hi}) < "
                          f"duration_lo ({lo})")
        classes = tr.get("classes")
        if classes is not None and (
                not isinstance(classes, (list, tuple)) or
                not all(isinstance(c, dict) for c in classes)):
            errors.append(
                "server_config.traffic.classes: expected a list of "
                "per-class mappings (fraction/rate/window/phase/"
                f"duration_scale), got {classes!r}")
        sa = sc.get("secure_agg") or {}
        if tr.get("enable", True) and isinstance(sa, dict) and \
                sa.get("enable", True):
            ms = sa.get("min_survivors")
            bs = tr.get("buffer_size", sc.get("num_clients_per_iteration"))
            if isinstance(ms, int) and isinstance(bs, int) and ms > bs:
                errors.append(
                    "server_config.secure_agg.min_survivors "
                    f"({ms}) exceeds traffic.buffer_size ({bs}) "
                    "— a buffered fire delivers exactly "
                    "buffer_size clients, so every round would "
                    "abort below the liveness floor")
    if errors:
        raise SchemaError(errors)


#: ``server_config.telemetry`` and its ``watchdog`` block, with the JAX
#: schema's keys and field rules (``msrflute_tpu/schema.py:334-403``)
TELEMETRY_KEYS = {
    "enable", "trace", "devbus", "profile_rounds", "watchdog", "xla",
    "scorecard", "rollup", "rollup_window", "flight", "flight_events",
    "max_log_mb",
}
WATCHDOG_KEYS = {
    "nan_loss", "round_time_action", "round_time_factor",
    "round_time_window", "ckpt_failure_action", "ckpt_failure_streak",
    "quarantine_rate_action", "quarantine_rate_threshold",
    "recompile_storm_action", "recompile_storm_threshold",
    "recompile_storm_warmup_rounds", "stall_action", "stall_factor",
    "stall_poll_secs", "stall_grace_secs", "rss_leak_action",
    "rss_leak_window", "rss_leak_mb_per_round", "throughput_drift_action",
    "throughput_drift_window", "throughput_drift_factor",
}
TELEMETRY_FIELD_SPECS = {
    "enable": ("bool", None, None), "trace": ("bool", None, None),
    "devbus": ("bool", None, None), "xla": ("bool", None, None),
    "scorecard": ("bool", None, None), "rollup": ("bool", None, None),
    "rollup_window": ("int", 1, None), "flight": ("bool", None, None),
    "flight_events": ("int", 8, None), "max_log_mb": ("num", 0, None),
}
WATCHDOG_FIELD_SPECS = {
    "round_time_factor": ("num", 1.0, None),
    "round_time_window": ("int", 4, None),
    "ckpt_failure_streak": ("int", 1, None),
    "quarantine_rate_threshold": ("num", 0.0, 1.0),
    "recompile_storm_threshold": ("int", 1, None),
    "recompile_storm_warmup_rounds": ("int", 0, None),
    "stall_factor": ("num", 1.0, None),
    "stall_poll_secs": ("num", 0.01, None),
    "stall_grace_secs": ("num", 0.0, None),
    "rss_leak_window": ("int", 4, None),
    "rss_leak_mb_per_round": ("num", 0.0, None),
    "throughput_drift_window": ("int", 4, None),
    "throughput_drift_factor": ("num", 1.0, None),
}
#: the watchdog's actions (``telemetry/watchdog.py::ACTIONS``)
ALLOWED_WATCHDOG_ACTIONS = ["off", "log", "mark", "abort"]
#: the watchdog keys that hold an action
WATCHDOG_ACTION_KEYS = (
    "nan_loss", "round_time_action", "ckpt_failure_action",
    "quarantine_rate_action", "recompile_storm_action", "stall_action",
    "rss_leak_action", "throughput_drift_action")


def _unknown_keys(unknown: List[str], raw: Dict[str, Any], path: str,
                  known: set) -> None:
    """Keys outside ``known``, in the JAX schema's words, with its
    did-you-mean hint (``schema.py:698-710``)."""
    import difflib
    for key in raw:
        if key in known:
            continue
        hint = difflib.get_close_matches(str(key), known, n=1, cutoff=0.6)
        suggest = f" (did you mean {hint[0]!r}?)" if hint else ""
        unknown.append(f"{path}.{key}: unknown key{suggest}")


def check_telemetry(telemetry: Any) -> None:
    """``server_config.telemetry`` as the JAX schema checks it
    (``schema.py:1136-1181``): a mapping of known keys and typed fields,
    ``profile_rounds`` through the profiler's own parser, and a
    ``watchdog`` mapping with known keys, typed fields and the four
    actions; every violation in its message, the unknown keys last."""
    from .telemetry.profiling import parse_profile_rounds
    if telemetry is None:
        return
    errors: List[str] = []
    unknown: List[str] = []
    if not isinstance(telemetry, dict):
        errors.append("server_config.telemetry: must be a mapping "
                      "(see docs/observability.md), got "
                      f"{type(telemetry).__name__}")
        raise SchemaError(errors)
    _unknown_keys(unknown, telemetry, "server_config.telemetry",
                  TELEMETRY_KEYS)
    _check_fields(errors, telemetry, "server_config.telemetry",
                  TELEMETRY_FIELD_SPECS)
    if telemetry.get("profile_rounds") is not None:
        try:
            parse_profile_rounds(telemetry["profile_rounds"])
        except (ValueError, TypeError) as exc:
            errors.append(f"server_config.telemetry.profile_rounds: {exc}")
    wd = telemetry.get("watchdog")
    if wd is not None and not isinstance(wd, dict):
        errors.append("server_config.telemetry.watchdog: must be a mapping "
                      f"of detector knobs, got {type(wd).__name__}")
    if isinstance(wd, dict):
        _unknown_keys(unknown, wd, "server_config.telemetry.watchdog",
                      WATCHDOG_KEYS)
        _check_fields(errors, wd, "server_config.telemetry.watchdog",
                      WATCHDOG_FIELD_SPECS)
        for key in WATCHDOG_ACTION_KEYS:
            val = wd.get(key)
            if val is not None and val not in ALLOWED_WATCHDOG_ACTIONS:
                errors.append(f"server_config.telemetry.watchdog.{key}: "
                              f"{val!r} not in {ALLOWED_WATCHDOG_ACTIONS}")
    errors.extend(unknown)
    if errors:
        raise SchemaError(errors)


def check_throughput(sc: Dict[str, Any], strategy: str) -> None:
    """The cohort-bucketing and megabatch blocks as the JAX schema checks
    them (``schema.py:968-1053``): their keys and field types, a strictly
    increasing list of positive ``boundaries`` no longer than
    ``max_buckets``, and ``megabatch`` only beside an enabled
    ``cohort_bucketing`` and never under FedLabels.  The combinations the
    JAX server and engine refuse raise there, in the port too."""
    errors: List[str] = []
    cb, mgb = sc.get("cohort_bucketing"), sc.get("megabatch")
    for name, blk, keys in (
            ("cohort_bucketing", cb, set(COHORT_BUCKETING_SPECS)
             | {"boundaries"}),
            ("megabatch", mgb, set(MEGABATCH_SPECS))):
        if blk is not None and not isinstance(blk, dict):
            errors.append(f"server_config.{name}: must be a mapping, got "
                          f"{type(blk).__name__}")
        elif blk:
            _check_keys(blk, f"server_config.{name}", keys)
    if isinstance(cb, dict):
        _check_fields(errors, cb, "server_config.cohort_bucketing",
                      COHORT_BUCKETING_SPECS)
        bounds = cb.get("boundaries")
        path = "server_config.cohort_bucketing.boundaries"
        if bounds is not None:
            if not isinstance(bounds, (list, tuple)) or not bounds:
                errors.append(f"{path}: must be a non-empty list of step "
                              "counts")
            elif any(isinstance(b, bool) or not isinstance(b, int) or b < 1
                     for b in bounds):
                errors.append(f"{path}: every boundary must be a positive "
                              f"integer, got {list(bounds)!r}")
            elif any(y <= x for x, y in zip(bounds, bounds[1:])):
                errors.append(f"{path}: must be strictly increasing, got "
                              f"{list(bounds)!r}")
            mb = cb.get("max_buckets")
            if isinstance(mb, int) and not isinstance(mb, bool) and \
                    isinstance(bounds, (list, tuple)) and len(bounds) > mb:
                errors.append(f"server_config.cohort_bucketing: "
                              f"{len(bounds)} boundaries exceed "
                              f"max_buckets={mb}")
    if isinstance(mgb, dict):
        _check_fields(errors, mgb, "server_config.megabatch",
                      MEGABATCH_SPECS)
        cb_on = bool(cb) and (not isinstance(cb, dict)
                              or cb.get("enable", True))
        if mgb.get("enable", True) and not cb_on:
            errors.append(
                "server_config.megabatch requires "
                "server_config.cohort_bucketing — the super-batch tape "
                "repacks per-bucket grids; add the cohort_bucketing block "
                "or drop megabatch")
        if mgb.get("enable", True) and strategy == "fedlabels":
            errors.append(
                "server_config.megabatch is set but strategy is "
                "'fedlabels' — its dual sup/unsup loop steps outside the "
                "client_update contract the lane scan reproduces; drop "
                "megabatch or change strategy")
    if errors:
        raise SchemaError(errors)


def _refuse(cond: bool, why: str) -> None:
    if cond:
        raise ValueError(why)


def check_strategy(raw: Dict[str, Any], strategy: str) -> None:
    """The combinations that the JAX strategies' constructors, its round
    engine (``engine/round.py:213-216, 297-316``) and its server
    (``engine/server.py:606-620, 632-636, 824-830``) refuse: each raises
    ``ValueError`` here, with their meaning."""
    from .strategies import STRATEGIES   # they import this module
    cls = STRATEGIES[strategy]
    sc = raw.get("server_config") or {}
    cc = raw.get("client_config") or {}
    model = raw.get("model_config") or {}
    dp = raw.get("dp_config") or {}
    local_dp = bool(dp.get("enable_local_dp", False))
    adaptive = bool(dp.get("adaptive_clipping"))
    server_opt = str((sc.get("optimizer_config") or {}).get(
        "type", "sgd")).lower()
    ef = strategy in ("ef_quant", "efquant")
    _refuse(bool(sc.get("wantRL")) and not cls.supports_rl,
            f"strategy {strategy!r} does not support wantRL")
    _refuse(bool(sc.get("wantRL")) and not isinstance(
        sc.get("num_clients_per_iteration", 10), int),
            "wantRL requires a fixed num_clients_per_iteration")
    _refuse(cls.owns_server_update and server_opt != "sgd",
            f"strategy {strategy!r} applies its own server update; server "
            f"optimizer_config type={server_opt!r} would be silently "
            "ignored — use sgd (the lr still scales the update)")
    train_server = (((sc.get("data_config") or {}).get("train") or {})
                    .get("train_data_server"))
    _refuse(cls.owns_server_update and
            bool(sc.get("server_replay_config")) and bool(train_server),
            f"strategy {strategy!r} maintains coupled parameter sequences; "
            "server replay would mutate params behind its back — disable "
            "server_replay_config")
    resident = (((cc.get("data_config") or {}).get("train") or {})
                .get("device_resident"))
    fused = fused_paths(raw, strategy)["fused"]
    _refuse(bool(resident) and not fused and (bool(sc.get("wantRL")) or
                                              cls.host_rounds),
            "data_config.train.device_resident does not apply to "
            "host-orchestrated rounds (wantRL / strategy: scaffold / "
            "strategy: ef_quant) — drop the flag for this configuration")
    _refuse(bool(sc.get("scaffold_device_controls")) and
            strategy != "scaffold",
            "server_config.scaffold_device_controls requires strategy: "
            "scaffold — drop the flag")
    _refuse(bool(sc.get("ef_device_residuals")) and not ef,
            "server_config.ef_device_residuals requires strategy: "
            "ef_quant — drop the flag")
    if strategy == "qffl":
        _refuse(local_dp or bool(dp.get("enable_global_dp", False)),
                "strategy: qffl does not compose with "
                "dp_config.enable_local_dp / enable_global_dp")
        _refuse(float(sc.get("qffl_q", 1.0)) < 0,
                f"server_config.qffl_q must be >= 0, got {sc.get('qffl_q')}")
    if strategy == "fedac":
        _refuse(adaptive, "FedAC and dp_config.adaptive_clipping both need "
                          "the strategy-state slot (w_ag vs dp_clip) — not "
                          "supported together; use strategy: fedavg for "
                          "adaptive clipping")
    if strategy == "fedbuff":
        fb = sc.get("fedbuff", True)
        _refuse(not isinstance(fb, (dict, bool)),
                "server_config.fedbuff must be a bool or an options dict")
        fb = fb if isinstance(fb, dict) else {}
        unknown = set(fb) - {"max_staleness", "staleness_exponent"}
        _refuse(bool(unknown), f"server_config.fedbuff has unknown keys "
                               f"{sorted(unknown)}")
        _refuse(int(fb.get("max_staleness", 4)) < 1,
                "fedbuff.max_staleness must be >= 1")
        _refuse(float(fb.get("staleness_exponent", 0.5)) < 0,
                "fedbuff.staleness_exponent must be >= 0")
        _refuse(adaptive, "FedBuff does not implement "
                          "dp_config.adaptive_clipping")
    if strategy == "scaffold":
        _refuse(local_dp or adaptive,
                "strategy: scaffold does not compose with "
                "dp_config.enable_local_dp / adaptive_clipping")
        oc = cc.get("optimizer_config") or {}
        plain = (str(oc.get("type", "sgd")).lower() == "sgd" and
                 not float(oc.get("momentum", 0.0) or 0.0) and
                 not bool(oc.get("nesterov", False)) and
                 not float(oc.get("weight_decay", 0.0) or 0.0))
        _refuse(not plain, "strategy: scaffold requires a PLAIN sgd client "
                           f"optimizer, got {oc!r}")
        _refuse(float(cc.get("fedprox_mu", 0.0) or 0.0) > 0.0,
                "strategy: scaffold does not compose with fedprox_mu")
        _refuse(cc.get("max_grad_norm") is not None,
                "strategy: scaffold does not compose with "
                "client_config.max_grad_norm")
        _refuse(bool(cc.get("freeze_layer") or cc.get("updatable_layers")),
                "strategy: scaffold does not compose with layer freezing")
        _refuse(cc.get("quant_thresh") is not None or
                model.get("quant_threshold") is not None,
                "strategy: scaffold does not compose with gradient "
                "quantization")
    check_fused_carry(raw, strategy)
    if ef:
        bits = int(cc.get("quant_bits", 4))
        _refuse(not 1 <= bits <= 16,
                f"ef_quant quant_bits must be in [1, 16], got {bits}")
        thresh = float(cc.get("quant_thresh", 0.0))
        _refuse(not 0.0 <= thresh < 1.0,
                "ef_quant quant_thresh is an |.|-quantile in [0, 1), got "
                f"{thresh}")


def fused_paths(raw: Dict[str, Any], strategy: str) -> Dict[str, bool]:
    """Which paths ``server_config.fused_carry`` moves onto the ring:
    SCAFFOLD's and EF's carry modes, personalization's carry and fused RL
    (``msrflute_tpu/engine/server.py:75-95, 179-191``)."""
    sc = raw.get("server_config") or {}
    fused = bool(sc.get("fused_carry", False))
    personal = str(sc.get("type", "optimization")) == "personalization"
    return {
        "fused": fused,
        "carry": fused and (strategy in ("scaffold", "ef_quant", "efquant")
                            or personal),
        "personal": fused and personal,
        "rl": fused and bool(sc.get("wantRL", False)),
    }


def paged_carry(raw: Dict[str, Any], strategy: str) -> bool:
    """Whether the run is the fleet paged carry: an enabled ``fleet``
    block beside a device-carry strategy (``server.py:103-107``)."""
    fl = (raw.get("server_config") or {}).get("fleet")
    return bool(isinstance(fl, dict) and fl and fl.get("enable", True)
                and fused_paths(raw, strategy)["carry"])


def check_fused_carry(raw: Dict[str, Any], strategy: str) -> None:
    """The refusals of ``fused_carry`` that the JAX package makes, each a
    ``ValueError`` as there: chunked clients under a carry strategy or
    fused RL (``engine/round.py:250-255, 329-332``); fused RL beside a
    carry strategy, a strategy without RL (a stack aggregator's
    ``RobustFedAvg`` too), a stateful strategy, adaptive clipping, masked
    multi-part payloads, ``stale_prob``, ``wantLSTM`` (``:296-338``); EF's
    carry with adaptive clipping (``strategies/ef_quant.py:312-322``);
    personalization's carry with local DP, another
    ``personalization_init`` or a strategy other than FedAvg / FedProx
    (``strategies/personalized.py:48-66``,
    ``engine/personalization.py:126-137``)."""
    from .strategies import STRATEGIES
    paths = fused_paths(raw, strategy)
    if not paths["fused"]:
        return
    cls = STRATEGIES[strategy]
    sc = raw.get("server_config") or {}
    dp = raw.get("dp_config") or {}
    adaptive = bool(dp.get("adaptive_clipping"))
    chunked = bool(sc.get("clients_per_chunk"))
    _refuse(paths["personal"] and strategy not in ("fedavg", "fedprox"),
            "fused_carry personalization composes only with strategy: "
            f"fedavg/fedprox (got {strategy!r}) — the carry tables replace "
            "the host store, and other strategies keep their own state; "
            "drop fused_carry")
    _refuse(paths["carry"] and chunked,
            "fused_carry is incompatible with clients_per_chunk: the carry "
            "scatter needs every client's update row, which chunked "
            "accumulation never materializes — disable one")
    _refuse(paths["carry"] and strategy in ("ef_quant", "efquant") and
            adaptive,
            "strategy: ef_quant with fused_carry does not compose with "
            "dp_config.adaptive_clipping — the carry state holds only the "
            "EF residual table; drop fused_carry or adaptive_clipping")
    if paths["personal"]:
        _refuse(bool(dp.get("enable_local_dp", False)),
                "fused_carry personalization does not compose with "
                "dp_config.enable_local_dp — the alpha update reads the raw "
                "global pseudo-gradient; drop fused_carry for DP runs")
        init = sc.get("personalization_init", "global")
        _refuse(init != "global",
                "fused_carry personalization supports only "
                f"personalization_init: global (got {init!r}) — drop "
                "fused_carry for the other modes")
    if not paths["rl"]:
        return
    robust = sc.get("robust") or {}
    # a stack aggregator swaps in RobustFedAvg, which takes no RL weights
    stack = bool(robust) and bool(robust.get("enable", True)) and \
        str(robust.get("aggregator", "mean")) in ("trimmed_mean", "median")
    _refuse(not cls.supports_rl or paths["personal"] or stack,
            f"strategy {strategy!r} does not support wantRL under "
            "fused_carry: the RL re-weighting assumes the plain "
            "single-payload flow")
    _refuse(cls.stateful or adaptive,
            "fused RL requires a stateless strategy combine (no "
            "adaptive_clipping / strategy state): the RL weights replace "
            "the combine entirely")
    _refuse(cls.wants_cohort or bool(cls.unit_weight_parts),
            "fused RL does not compose with masked multi-part payloads "
            "(secure_agg/fedlabels)")
    _refuse(chunked, "fused RL is incompatible with clients_per_chunk: "
                     "re-weighting needs the full payload stack")
    _refuse(float(sc.get("stale_prob", 0.0) or 0.0) > 0.0,
            "fused RL does not support stale_prob")
    _refuse(bool((sc.get("RL") or {}).get("wantLSTM", False)),
            "fused RL does not support wantLSTM — the state-window "
            "recurrence is host-side; drop fused_carry for LSTM RL runs")


def check_defense(raw: Dict[str, Any], strategy: str) -> None:
    """``server_config.chaos``, ``robust`` and ``secure_agg`` and adaptive
    clipping: their options as the JAX schema and constructors check them
    (``msrflute_tpu/schema.py:816-830, 864-968``), with ``ValueError``; the
    combinations that the JAX strategies, engine and server refuse
    (``strategies/robust.py``, ``engine/round.py:411-467``,
    ``engine/server.py:172-233``; the infra services without the fleet
    paged carry among them), with ``ValueError``; and
    ``clients_per_chunk`` beside ``dump_norm_stats`` or a ``robust``
    block (``engine/round.py:233-240, 442-447``), with ``ValueError``."""
    from .resilience.chaos import make_chaos
    from .robust import make_shield
    from .strategies import STRATEGIES
    from .strategies.secure_agg import check_options
    cls = STRATEGIES[strategy]
    sc = raw.get("server_config") or {}
    dp = raw.get("dp_config") or {}
    secagg = strategy in _SECURE_AGG_NAMES
    # fused_carry moves the host rounds onto the round path
    # (``engine/server.py:179-191``)
    host = not fused_paths(raw, strategy)["fused"] and (
        bool(sc.get("wantRL")) or cls.host_rounds or
        str(sc.get("type", "optimization")) == "personalization")
    adaptive = bool(dp.get("adaptive_clipping"))
    _refuse(adaptive and not cls.supports_adaptive_clipping,
            f"strategy {strategy!r} does not implement "
            "dp_config.adaptive_clipping — use strategy: fedavg")
    _refuse(adaptive and strategy in ("fedavg", "fedprox") and
            not dp.get("enable_local_dp", False),
            "dp_config.adaptive_clipping requires enable_local_dp: true "
            "(the clip applies inside the local-DP transform)")

    if sc.get("secure_agg") is not None and not secagg:
        raise ValueError(
            "server_config.secure_agg is set but strategy is "
            f"{strategy!r} — only strategy: secure_agg reads it; "
            "payloads would flow UNMASKED")
    if secagg:
        check_options(sc.get("secure_agg", True),
                      sc.get("num_clients_per_iteration", 10), dp,
                      bool(raw.get("dump_norm_stats",
                                   sc.get("dump_norm_stats", False))))

    chaos = sc.get("chaos")
    if chaos is not None:
        _check_keys(chaos, "server_config.chaos", _CHAOS)
        infra = chaos.get("infra")
        _check_keys(infra, "server_config.chaos.infra", _CHAOS_INFRA)
        seed = chaos.get("seed", 0)
        if not isinstance(seed, int) or isinstance(seed, bool) or seed < 0:
            raise ValueError(f"server_config.chaos.seed must be an int >= 0, "
                             f"got {seed!r}")
        schedule = make_chaos(sc)   # the constructor's range checks
        if schedule is not None:
            _refuse(schedule.has_infra_faults and not paged_carry(raw,
                                                                  strategy),
                    INFRA_NEEDS_PAGING)
            faults = schedule.has_client_faults or schedule.has_corruption
            _refuse(faults and host,
                    "server_config.chaos dropout_rate/straggler_rate/"
                    "corrupt_* rates require the fused round path — "
                    "wantRL, strategy: scaffold / ef_quant, and "
                    "personalization orchestrate rounds host-side and "
                    "would ignore the injected faults; zero those rates "
                    "or drop the feature")
            _refuse(schedule.has_corruption and strategy == "fedlabels",
                    "server_config.chaos corrupt_* rates corrupt the "
                    "default payload part, and fedlabels sends its "
                    "sup / unsup parts instead — zero those rates")

    chunked = bool(sc.get("clients_per_chunk"))
    _refuse(chunked and bool(raw.get("dump_norm_stats",
                                     sc.get("dump_norm_stats", False))),
            "clients_per_chunk is incompatible with dump_norm_stats: "
            "per-client cosines need every payload against the final "
            "aggregate, which chunked accumulation never materializes — "
            "disable one of them")
    _refuse(chunked and make_shield(sc) is not None,
            "server_config.robust is incompatible with clients_per_chunk: "
            "median-of-norms screening (and the trimmed-mean/median payload "
            "stack) needs every client's payload against the full cohort, "
            "which chunked accumulation never materializes — disable one "
            "of them")
    robust = sc.get("robust")
    if robust is not None:
        _check_keys(robust, "server_config.robust", _ROBUST)
        shield = make_shield(sc)   # the constructor's checks
        # the schema's rules read the block as written (an empty block is
        # on there, though the server then builds no shield)
        if robust.get("enable", True):
            aggregator = str(robust.get("aggregator", "mean"))
            _refuse(strategy not in ("fedavg", "fedprox") and not secagg,
                    "server_config.robust requires strategy: fedavg/"
                    f"fedprox/secure_agg — {strategy!r} aggregates through "
                    "its own parts and would ignore the screening; drop "
                    "the robust block or the strategy")
            _refuse(aggregator in ("trimmed_mean", "median") and secagg,
                    f"robust.aggregator={aggregator!r} sorts "
                    "per-client payload coordinates, but secure_agg "
                    "submissions are masked int32 group elements — use "
                    "aggregator: mean (submitted-norm screening still "
                    "applies)")
        if shield is not None:
            _refuse(adaptive,
                    "server_config.robust is incompatible with "
                    "dp_config.adaptive_clipping: quarantined clients' "
                    "below-clip votes would still steer the clip quantile "
                    "— use a fixed max_grad or drop the robust block")
            _refuse(host,
                    "server_config.robust requires the fused round path "
                    "— wantRL, strategy: scaffold / ef_quant, and "
                    "personalization orchestrate rounds host-side and "
                    "would aggregate unscreened payloads; drop the "
                    "robust block for this configuration")


def model_dtype(model: Dict[str, Any]) -> str:
    """``model_config.dtype`` as ``float32``, ``bfloat16`` or ``float16``
    (the JAX package's ``parse_dtype`` spellings); ValueError otherwise."""
    name = str(model.get("dtype", "float32") or "float32").lower()
    if name not in DTYPE_NAMES:
        raise ValueError(f"model_config.dtype={name!r}; expected one of "
                         f"{sorted(DTYPE_NAMES)}")
    return DTYPE_NAMES[name]


def check_precision(prec: Any, model_type: Optional[str]) -> None:
    """``server_config.precision``: a mapping of ``enable`` (bool) and
    ``params`` / ``compute`` / ``stats`` dtypes.  A non-float32 ``params``
    or ``compute`` casts the leaves, which only the models of
    :data:`DTYPE_MODELS` take (each layer casts to its own dtype)."""
    if prec is None:
        return
    if not isinstance(prec, dict):
        raise ValueError("server_config.precision must be a mapping, got "
                         f"{type(prec).__name__}")
    _check_keys(prec, "server_config.precision", _PRECISION)
    if prec.get("enable") is not None and \
            not isinstance(prec["enable"], bool):
        raise ValueError("server_config.precision.enable must be a bool, "
                         f"got {prec['enable']!r}")
    for key in ("params", "compute", "stats"):
        value = prec.get(key)
        if value is not None and str(value) not in _PRECISION_DTYPES:
            raise ValueError(f"server_config.precision.{key}={value!r}: one "
                             f"of {list(_PRECISION_DTYPES)}")
    casts = [k for k in ("params", "compute")
             if str(prec.get(k) or "float32") != "float32"]
    if casts and prec.get("enable", True) and model_type not in DTYPE_MODELS:
        raise NotImplementedError(
            f"server_config.precision.{casts[0]} on model_type "
            f"{model_type!r} is {NOT_PORTED} (the port casts per layer on "
            f"{sorted(DTYPE_MODELS)} only)")


def check_ringlm_model(model: Dict[str, Any]) -> None:
    """RingLM's local mode is ported whole: ``flash_attention`` a bool or
    ``"auto"``, ``remat`` and ``moe_experts``; the TPU tile knobs
    ``flash_block_q``/``flash_block_k`` change no result and are ignored.
    The expert-parallel MoE dispatch (``moe_ep_axis``) is multi-GPU and
    raises."""
    flash = model.get("flash_attention", False)
    if isinstance(flash, str) and flash.lower() != "auto":
        raise ValueError("model_config.flash_attention must be bool or "
                         f"'auto', got {flash!r}")
    if model.get("moe_ep_axis") is not None:
        raise NotImplementedError(
            f"model_config.moe_ep_axis={model['moe_ep_axis']!r}: the "
            "expert-parallel MoE dispatch (multi-GPU) is "
            f"{NOT_PORTED} §A")
    experts = model.get("moe_experts", 0) or 0
    if isinstance(experts, bool) or not isinstance(experts, int) or \
            experts < 0:
        raise ValueError("model_config.moe_experts must be an integer >= 0, "
                         f"got {experts!r}")


def check_mesh(mesh: Any) -> None:
    """One device: ``mesh_config.model_axis_size`` must be 1 (the JAX
    package's ``make_mesh`` refuses 4 on one chip too)."""
    size = int((mesh or {}).get("model_axis_size", 1) or 1)
    if size > 1:
        raise NotImplementedError(
            f"mesh_config.model_axis_size={size}: tensor parallelism over "
            "several GPUs (multi-GPU) is in ROADMAP.md §A; the port runs "
            f"one device, so set it to 1 ({NOT_PORTED} §A)")


def check_bert_model(model: Dict[str, Any]) -> None:
    """The BERT masked LM is ported from a fresh init, in any
    ``model_config.dtype`` spelling (``BERT.model.dtype`` first), with the
    full or the gathered MLM head; a checkpoint path raises (it loads
    Hugging Face weights, a download)."""
    bert = dict((model.get("BERT") or {}).get("model") or {})
    if bert.get("model_name_or_path"):
        raise NotImplementedError(
            "BERT.model.model_name_or_path (Hugging Face weights) is "
            f"{NOT_PORTED} §A")
    model_dtype(bert if "dtype" in bert else model)
    head = str(bert.get("mlm_head", "full")).lower()
    if head not in ("full", "gathered"):
        raise ValueError("BERT.model.mlm_head must be 'full' or "
                         f"'gathered', got {head!r}")


def _check_optimizer(raw: Any, path: str) -> None:
    """One of the JAX package's optimizer types with the keys it reads."""
    raw = raw or {}
    kind = str(raw.get("type", "sgd")).lower()
    if kind not in _OPTIMIZER_KEYS:
        raise ValueError(f"{path}.type={raw.get('type')!r}: one of "
                         f"{sorted(_OPTIMIZER_KEYS)}")
    _check_keys(raw, path, _OPTIMIZER_KEYS[kind],
                off_ok=_OFF_OK["optimizer"], ignored=_INERT["optimizer"])
    errors: List[str] = []
    _check_fields(errors, raw, path, _INERT_SPECS["optimizer"])
    if errors:
        raise SchemaError(errors)
