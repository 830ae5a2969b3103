"""Task registry — ``model_config.model_type`` -> task factory (the port's
counterpart of ``msrflute_tpu/models/registry.py``), and the
``model_folder`` plugin loader.

A plugin folder (``experiments/hello_mlp``) holds ``config.py``, plain
Python whose ``<model_type>Config.defaults`` fill the model config's
missing keys (explicit YAML keys win), and ``task.py``, the JAX package's
``make_task(model_config)``.  The port never executes ``task.py``: it
imports flax and ``msrflute_tpu``.  It builds the task from, in order,

1. ``<model_folder>/task_torch.py``, the port's plugin contract (the same
   ``make_task(model_config)``, returning a :class:`~.base.BaseTask`);
2. the built-in twin ``msrflute_tpu_torch/plugins/<folder name>.py``;

and raises ``NotImplementedError`` naming both when neither exists.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

from ..config import NOT_PORTED
from .base import BaseTask
from .bert import make_bert_task
from .cv import make_cifar_cnn_task, make_cnn_femnist_task, make_lr_task
from .ecg import make_ecg_task
from .fednewsrec import make_nrms_task
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
    "ECG_CNN": make_ecg_task,
    "NRMS": make_nrms_task,
    "FEDNEWSREC": make_nrms_task,
    "BERT": make_bert_task,
}

#: the plugin file the port loads from a model folder
PLUGIN_FILE = "task_torch.py"
PLUGINS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plugins")


def _exec_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod


def _apply_plugin_config(model_config, folder: str) -> None:
    """Merge ``<model_type>Config`` of ``<folder>/config.py`` into the
    model config: its ``defaults`` dict, else its public non-callable
    attributes, for every key the config does not set."""
    cfg_path = os.path.join(folder, "config.py")
    if not os.path.exists(cfg_path):
        return
    mod = _exec_file(cfg_path, "flute_torch_plugin_cfg")
    cls = getattr(mod, model_config.get("model_type", "LR") + "Config", None)
    if cls is None:
        return
    defaults = getattr(cls, "defaults", None)
    if defaults is None:
        defaults = {k: v for k, v in vars(cls).items()
                    if not k.startswith("_") and not callable(v)}
    for key, value in defaults.items():
        if model_config.get(key) is None:
            model_config[key] = value


def _make_plugin_task(model_config, folder: str) -> BaseTask:
    _apply_plugin_config(model_config, folder)
    plugin = os.path.join(folder, PLUGIN_FILE)
    if os.path.exists(plugin):
        return _exec_file(plugin, "flute_torch_plugin").make_task(
            model_config)
    name = os.path.basename(os.path.normpath(folder))
    twin = os.path.join(PLUGINS_DIR, f"{name}.py")
    if name.isidentifier() and os.path.exists(twin):
        module = importlib.import_module(f"msrflute_tpu_torch.plugins.{name}")
        return module.make_task(model_config)
    raise NotImplementedError(
        f"model_folder {folder!r}: the port needs {plugin} or its built-in "
        f"twin {twin}; neither exists ({NOT_PORTED})")


def make_task(model_config) -> BaseTask:
    folder = model_config.get("model_folder")
    if folder:
        return _make_plugin_task(model_config, folder)
    model_type = model_config.get("model_type", "LR")
    if model_type not in TASK_REGISTRY:
        raise NotImplementedError(f"model_type {model_type!r} is {NOT_PORTED}")
    return TASK_REGISTRY[model_type](model_config)
