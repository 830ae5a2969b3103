"""Task registry — ``model_config.model_type`` -> task factory (the port's
counterpart of ``msrflute_tpu/models/registry.py``)."""

from __future__ import annotations

from ..config import NOT_PORTED
from .base import BaseTask
from .cv import make_cifar_cnn_task, make_cnn_femnist_task, make_lr_task
from .nlp import make_gru_lm_task, make_shakespeare_lstm_task
from .resnet import make_resnet_task
from .ringlm import make_ringlm_task

TASK_REGISTRY = {
    "LR": make_lr_task,
    "CNN": make_cnn_femnist_task,
    "CNN_FEMNIST": make_cnn_femnist_task,
    "CIFAR_CNN": make_cifar_cnn_task,
    "RESNET": make_resnet_task,
    "ResNet": make_resnet_task,
    "RNN": make_shakespeare_lstm_task,
    "LSTM": make_shakespeare_lstm_task,
    "GRU": make_gru_lm_task,
    "RINGLM": make_ringlm_task,
}


def make_task(model_config) -> BaseTask:
    model_type = model_config.get("model_type", "LR")
    if model_type not in TASK_REGISTRY:
        raise NotImplementedError(f"model_type {model_type!r} is {NOT_PORTED}")
    return TASK_REGISTRY[model_type](model_config)
