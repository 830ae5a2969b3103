"""Computer-vision tasks — the port's counterpart of ``msrflute_tpu/models/cv.py``:
LR (MNIST), CNN_FEMNIST and CIFAR_CNN (with its F1 scores).

Layouts follow the JAX package at the public boundary: images are NHWC
(``[N, 28, 28, 1]``, ``[N, 32, 32, 3]``); the CNNs permute to NCHW for
``conv2d`` and back to NHWC before the flatten, so ``Dense_0``'s inputs
are in flax order and weights carry across 1:1 (:mod:`.convert`).
Parameter names are the flax module names: ``Conv_0.weight``,
``Dense_1.bias``, ...

``model_config.dtype`` (bfloat16, float16) is the JAX modules' ``dtype``:
each convolution and dense layer casts its input, weight and bias to it
and outputs it (flax's ``promote_dtype``), images normalize in it; the
parameters stay float32 and the logits come back float32.  The same
casts serve a precision policy's 16-bit leaves in a float32 model.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import rand_augment
from ..data.dataset import ArraysDataset
from ..data.featurize import to_image
from ..data.user_blob import UserBlob
from .base import (BaseTask, Batch, Metric, Params, conv, dropout,
                   lecun_normal_, linear, masked_mean, parse_dtype,
                   softmax_xent, to_float_image)


class LRModule(nn.Module):
    """Logistic regression (reference ``experiments/cv_lr_mnist/model.py``).
    ``sigmoid_output=True`` reproduces the reference's quirk of feeding
    sigmoid activations, not logits, into the cross entropy."""

    def __init__(self, num_classes: int = 10, input_dim: int = 784,
                 sigmoid_output: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = nn.Linear(input_dim, num_classes)
        self.sigmoid_output = sigmoid_output
        self.dtype = dtype

    def forward(self, x, masks: Tuple[torch.Tensor, ...] = ()):
        out = linear(self.Dense_0, to_float_image(x, self.dtype).reshape(
            x.shape[0], -1), self.dtype)
        return torch.sigmoid(out) if self.sigmoid_output else out


class CNNFEMNISTModule(nn.Module):
    """The FEMNIST benchmark CNN (reference
    ``experiments/cv_cnn_femnist/model.py``, FedML ``CNN_DropOut``):
    conv3x3x32 VALID -> relu -> conv3x3x64 VALID -> relu -> maxpool2 ->
    dropout(.25) -> flatten(9216) -> fc128 -> relu -> dropout(.5) -> fc62."""

    def __init__(self, num_classes: int = 62, drop1: float = 0.25,
                 drop2: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 32, 3)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dense_0 = nn.Linear(9216, 128)
        self.Dense_1 = nn.Linear(128, num_classes)
        self.drop1, self.drop2 = drop1, drop2
        self.dtype = dtype

    def forward(self, x, masks: Tuple[torch.Tensor, ...] = ()):
        dt = self.dtype
        if x.ndim == 3:
            x = x[..., None]
        x = to_float_image(x, dt).permute(0, 3, 1, 2)      # NHWC -> NCHW
        x = F.relu(conv(self.Conv_0, x, dt))
        x = F.relu(conv(self.Conv_1, x, dt))
        x = F.max_pool2d(x, 2).permute(0, 2, 3, 1)         # back to NHWC
        live = iter(masks)
        if masks and self.drop1 > 0:
            x = dropout(x, next(live), self.drop1)
        x = F.relu(linear(self.Dense_0, x.reshape(x.shape[0], -1), dt))
        if masks and self.drop2 > 0:
            x = dropout(x, next(live), self.drop2)
        return linear(self.Dense_1, x, dt)


class CIFARCNNModule(nn.Module):
    """The CIFAR-10 CNN (reference ``experiments/classif_cnn/model.py:33-62``):
    conv3x3x32 SAME -> relu -> maxpool2 -> conv3x3x64 SAME -> relu ->
    maxpool2 -> conv3x3x64 SAME -> relu -> flatten(4096) -> fc64 -> relu ->
    fc."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Conv_2 = nn.Conv2d(64, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(8 * 8 * 64, 64)
        self.Dense_1 = nn.Linear(64, num_classes)
        self.dtype = dtype

    def forward(self, x, masks: Tuple[torch.Tensor, ...] = ()):
        dt = self.dtype
        x = to_float_image(x, dt).permute(0, 3, 1, 2)      # NHWC -> NCHW
        x = F.max_pool2d(F.relu(conv(self.Conv_0, x, dt)), 2)
        x = F.max_pool2d(F.relu(conv(self.Conv_1, x, dt)), 2)
        x = F.relu(conv(self.Conv_2, x, dt)).permute(0, 2, 3, 1)
        x = F.relu(linear(self.Dense_0, x.reshape(x.shape[0], -1), dt))
        return linear(self.Dense_1, x, dt)


class ClassificationTask(BaseTask):
    """Masked classification over an ``nn.Module``.  ``with_f1`` adds the
    per-class true/false positive and false negative sums to the eval
    stats, and the micro F1 (``f1_score``, the reference's sklearn
    ``average='micro'``) and the macro F1 over the classes seen
    (``f1_macro``) to the metrics, as the JAX task does."""

    def __init__(self, module: nn.Module, example_shape: Tuple[int, ...],
                 name: str, num_classes: int,
                 dropout_sites: Sequence[Tuple[float, Tuple[int, ...]]] = (),
                 with_f1: bool = False):
        self.module = module
        self.example_shape = tuple(example_shape)
        self.name = name
        self.num_classes = num_classes
        self.dropout_sites = tuple(dropout_sites)
        self.with_f1 = with_f1

    def init_params(self, seed: int) -> Params:
        """flax's defaults: lecun-normal kernels, zero biases; drawn on the
        CPU so every device starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            if name.endswith(".weight"):
                lecun_normal_(t, int(np.prod(shape[1:])), gen)
            out[name] = t
        return out

    def predict(self, params: Params, batch: Batch):
        """The ``wantLogits`` payload (``msrflute_tpu/models/cv.py:125``):
        ``(logits [B, C], pred [B], labels [B])``, padded rows labelled
        -1."""
        logits = self.apply(params, batch["x"])
        labels = torch.where(batch["sample_mask"] > 0, batch["y"].long(),
                             torch.full_like(batch["y"].long(), -1))
        return logits, torch.argmax(logits, dim=-1), labels

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        logits = self.apply(params, batch["x"], masks)
        return masked_mean(softmax_xent(logits, batch["y"]),
                           batch["sample_mask"])

    def eval_stats(self, params: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        logits = self.apply(params, batch["x"])
        labels = batch["y"].long()
        mask = batch["sample_mask"]
        per_sample = softmax_xent(logits, labels)
        pred = torch.argmax(logits, dim=-1)
        correct = (pred == labels).to(torch.float32)
        stats = {"loss_sum": torch.sum(per_sample * mask),
                 "correct_sum": torch.sum(correct * mask),
                 "sample_count": torch.sum(mask)}
        if self.with_f1:
            true = F.one_hot(labels, self.num_classes) * mask[:, None]
            hit = F.one_hot(pred, self.num_classes) * mask[:, None]
            stats["tp"] = torch.sum(true * hit, dim=0)
            stats["fp"] = torch.sum((1 - true) * hit, dim=0)
            stats["fn"] = torch.sum(true * (1 - hit), dim=0)
        return stats

    def finalize_metrics(self, sums: Dict[str, float]) -> Dict[str, Metric]:
        metrics = super().finalize_metrics(sums)
        if self.with_f1 and "tp" in sums:
            tp, fp, fn = (np.asarray(sums[k], np.float64)
                          for k in ("tp", "fp", "fn"))
            metrics["f1_score"] = Metric(float(
                2 * tp.sum() / max(2 * tp.sum() + fp.sum() + fn.sum(),
                                   1e-8)))
            # sklearn's macro average: classes seen in labels or predictions
            denom = 2 * tp + fp + fn
            seen = denom > 0
            metrics["f1_macro"] = Metric(float(
                np.sum(2 * tp[seen] / denom[seen]) / max(seen.sum(), 1)))
        return metrics

    def make_dataset(self, blob: UserBlob, data_config=None,
                     split: str = "train") -> ArraysDataset:
        """Featurize an image/vector user blob into ``{"x", "y"}`` arrays
        (``x`` reshaped to the example shape; uint8 pixels stay uint8).

        Semisupervision blobs hold per-user dicts with an unlabeled stream
        ``ux`` (and optionally its augmented view ``ux_rand``); with
        ``data_config.augment`` on the train split, ``ux_rand`` is made
        here by RandAugment from one ``aug_rng`` shared by all users and
        seeded by ``augment.seed`` (0), as in the JAX package
        (``msrflute_tpu/models/cv.py:193-243``)."""
        aug_cfg = (dict((data_config or {}).get("augment") or {})
                   if split == "train" else {})
        aug_rng = np.random.default_rng(int(aug_cfg.get("seed", 0)))
        per_user = []
        for i in range(len(blob)):
            label = (blob.user_labels[i] if blob.user_labels is not None
                     else None)
            per_user.append(self.featurize_user(blob.user_data[i], label,
                                                aug_cfg, aug_rng))
        return ArraysDataset(blob.user_list, per_user, blob.num_samples)

    def featurize_user(self, data, label, aug_cfg=None, aug_rng=None
                       ) -> Dict[str, np.ndarray]:
        """One user's raw blob entry featurized, the per-user unit of
        :meth:`make_dataset` that a lazy dataset calls on access
        (``msrflute_tpu/models/cv.py:218``); lazy callers pass no
        ``aug_cfg``, as augmentation needs the shared stream."""
        aug_cfg = aug_cfg or {}
        raw_x = data["x"] if isinstance(data, dict) else data
        x = to_image(np.asarray(raw_x), self.example_shape)
        y = (np.asarray(label).astype(np.int32) if label is not None
             else np.zeros((len(x),), np.int32))
        user = {"x": x, "y": y}
        if isinstance(data, dict) and "ux" in data:
            user["ux"] = ux = to_image(np.asarray(data["ux"]),
                                       self.example_shape)
            if "ux_rand" in data:
                user["ux_rand"] = to_image(np.asarray(data["ux_rand"]),
                                           self.example_shape)
            elif aug_cfg:
                user["ux_rand"] = rand_augment(
                    ux, num_ops=int(aug_cfg.get("num_ops", 2)),
                    magnitude=int(aug_cfg.get("magnitude", 9)), rng=aug_rng)
        return user


def make_lr_task(model_config) -> ClassificationTask:
    num_classes = int(model_config.get("num_classes", 10))
    input_dim = int(model_config.get("input_dim", 784))
    return ClassificationTask(
        LRModule(num_classes, input_dim,
                 bool(model_config.get("sigmoid_output", False)),
                 parse_dtype(model_config)),
        example_shape=(input_dim,), name="cv_lr_mnist",
        num_classes=num_classes)


def make_cnn_femnist_task(model_config) -> ClassificationTask:
    num_classes = int(model_config.get("num_classes", 62))
    side = int(model_config.get("image_size", 28))
    if side != 28:
        raise ValueError("CNN_FEMNIST needs image_size 28 (Dense_0 takes "
                         f"12*12*64 inputs), got {side}")
    drop1 = float(model_config.get("dropout1", 0.25))
    drop2 = float(model_config.get("dropout2", 0.5))
    return ClassificationTask(
        CNNFEMNISTModule(num_classes, drop1, drop2,
                         parse_dtype(model_config)),
        example_shape=(side, side, 1), name="cv_cnn_femnist",
        num_classes=num_classes,
        dropout_sites=((drop1, (12, 12, 64)), (drop2, (128,))))


def make_cifar_cnn_task(model_config) -> ClassificationTask:
    num_classes = int(model_config.get("num_classes", 10))
    return ClassificationTask(
        CIFARCNNModule(num_classes, parse_dtype(model_config)),
        example_shape=(32, 32, 3),
        name="classif_cnn", num_classes=num_classes, with_f1=True)
