"""``model_config.dtype`` (bfloat16, float16) in the port's models against the
JAX package's, on the same weights carried across by
``msrflute_tpu_torch.models.convert.from_jax_params``, at small widths:
LR, CNN_FEMNIST, CIFAR_CNN, ResNet-18-GN, the Shakespeare LSTM and RingLM
(dense and flash arms; the JAX flash arm on the CPU is its dense
reference, the port's is the kernels' plain versions).

Each layer casts its input and weights to the dtype, as flax's
``promote_dtype`` does, so both packages round the same products to the
same 8 (bf16) or 11 (f16) mantissa bits; they differ in where the float32
sums inside a product round (XLA's CPU dots against PyTorch's), in a bf16
elementwise op evaluated in float32 before one rounding (PyTorch) or
after each op (XLA may keep excess precision), and in GroupNorm's
variance formula.  Tolerances, relative to the JAX value (the loss) or in
the global relative L2 of the gradient:

- the loss: ``LOSS_TOL`` 1e-2 (bfloat16) and 2e-3 (float16); measured at
  most 1.6e-4 and 2.2e-5 (RingLM's dense arm, CIFAR_CNN);
- the gradient against the JAX gradient in the same dtype: ``GRAD_TOL``
  3e-2 (bfloat16) and 4e-3 (float16); measured up to 1.73e-2 (the LSTM)
  and 1.44e-2 (RingLM) in bf16, 1.85e-3 in f16.  That is the size of the
  rounding itself: each package's bf16 gradient lies 1.5-4.7 % from the
  float32 one (the LSTM: JAX 1.9e-2, the port 3.9e-3);
- so the bf16 gradient is also held to the float32 JAX gradient: no
  farther than ``F32_FACTOR`` (1.5) times the JAX bf16 gradient's
  distance from it.

The params stay float32 and the logits come back float32 in both.  A
3-round CLI trajectory of each family in bf16 against the JAX server is
``tests/test_torch_dtype_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.base import parse_dtype, to_float_image
from msrflute_tpu_torch.models.convert import from_jax_params

LOSS_TOL = {"bfloat16": 1e-2, "float16": 2e-3}
GRAD_TOL = {"bfloat16": 3e-2, "float16": 4e-3}
F32_FACTOR = 1.5

RINGLM = {"model_type": "RINGLM", "vocab_size": 40, "embed_dim": 32,
          "num_heads": 2, "head_dim": 8, "mlp_dim": 64, "num_layers": 2,
          "seq_len": 33}
MODELS = {
    "lr": {"model_type": "LR", "num_classes": 4, "input_dim": 8},
    "cnn": {"model_type": "CNN", "num_classes": 62, "dropout1": 0.0,
            "dropout2": 0.0},
    "cifar": {"model_type": "CIFAR_CNN", "num_classes": 10},
    "resnet": {"model_type": "RESNET", "num_classes": 10, "image_size": 8,
               "channels_per_group": 16},
    "lstm": {"model_type": "RNN", "vocab_size": 30, "hidden_dim": 16,
             "seq_len": 12},
    "ringlm_dense": dict(RINGLM, flash_attention=False),
    "ringlm_flash": dict(RINGLM, flash_attention=True),
}


def _tasks(raw, dtype):
    extra = {k: v for k, v in raw.items() if k != "model_type"}
    extra["dtype"] = dtype
    jt = jax_make_task(JaxModelConfig(model_type=raw["model_type"],
                                      extra=dict(extra)))
    pt = make_task(ModelConfig(model_type=raw["model_type"],
                               extra=dict(extra)))
    return jt, pt


def _batch(raw, n=6, seed=0):
    rng = np.random.default_rng(seed)
    kind = raw["model_type"]
    mask = np.ones((n,), np.float32)
    mask[-1] = 0.0                       # a padded row must not count
    if kind in ("RNN", "RINGLM"):
        L = raw["seq_len"]
        x = rng.integers(1, raw["vocab_size"], size=(n, L)).astype(np.int32)
        x[0, L // 2:] = 0                # a padded tail
        return {"x": x, "sample_mask": mask}
    if kind == "LR":
        x = rng.normal(size=(n, 8)).astype(np.float32)
    elif kind == "CIFAR_CNN":
        x = rng.integers(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
    elif kind == "RESNET":
        side = raw["image_size"]
        x = rng.integers(0, 256, size=(n, side, side, 3)).astype(np.uint8)
    else:
        x = rng.integers(0, 256, size=(n, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, raw["num_classes"], size=(n,)).astype(np.int32)
    return {"x": x, "y": y, "sample_mask": mask}


#: each model's JAX initial params, drawn once for both dtypes: flax draws
#: them in float32 whatever the module's dtype (the same arrays, bitwise,
#: from the bfloat16, float16 and float32 tasks)
_jax_init = {}


def _init(name, jt):
    if name not in _jax_init:
        _jax_init[name] = jax.device_get(
            jt.init_params(jax.random.PRNGKey(3)))
    return _jax_init[name]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_grad_match_jax(name, dtype):
    raw = MODELS[name]
    jt, pt = _tasks(raw, dtype)
    jp = _init(name, jt)
    tp = from_jax_params(pt, jp)
    assert all(v.dtype == torch.float32 for v in tp.values())
    b = _batch(raw)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, train=False), has_aux=True)(jp)
    tl = pt.loss_masked(tp, tb)
    tg = grad(pt.loss_masked)(tp, tb)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl)), \
        (float(tl), float(jl))
    want = from_jax_params(pt, jax.device_get(jg))
    assert all(tg[k].dtype == torch.float32 for k in tg)
    flat = lambda d: np.concatenate([d[k].numpy().ravel()  # noqa: E731
                                     for k in sorted(d)])
    got, want = flat(tg), flat(want)
    assert _rel(got, want) <= GRAD_TOL[dtype], _rel(got, want)
    if dtype != "bfloat16":
        return
    # against the float32 gradient of the JAX package
    jt32, _ = _tasks(raw, "float32")
    ref = flat(from_jax_params(pt, jax.device_get(jax.grad(
        lambda p: jt32.loss(p, jb, None, train=False)[0])(jp))))
    assert _rel(got, ref) <= F32_FACTOR * _rel(want, ref), \
        (_rel(got, ref), _rel(want, ref))


@pytest.mark.parametrize("name", ["lr", "cnn", "resnet", "lstm",
                                  "ringlm_flash"])
def test_logits_come_back_float32_from_a_16_bit_model(name):
    raw = MODELS[name]
    _, pt = _tasks(raw, "bf16")
    assert pt.module.dtype == torch.bfloat16
    tp = pt.init_params(0)
    assert all(v.dtype == torch.float32 for v in tp.values())
    x = torch.from_numpy(_batch(raw)["x"])
    if raw["model_type"] in ("RNN", "RINGLM"):
        x = x[:, :-1]
    assert pt.apply(tp, x).dtype == torch.float32


def test_parse_dtype_takes_the_jax_spellings():
    for name, want in (("float32", torch.float32), ("f32", torch.float32),
                       ("bfloat16", torch.bfloat16), ("BF16", torch.bfloat16),
                       ("float16", torch.float16), ("f16", torch.float16),
                       (None, torch.float32)):
        assert parse_dtype({"dtype": name}) == want
    with pytest.raises(ValueError, match="model_config.dtype"):
        parse_dtype({"dtype": "int8"})


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_uint8_pixels_scale_in_the_dtype_as_jax_does(dtype):
    """``x.astype(dtype) * (1 / 255)``: JAX rounds the weakly typed factor
    to the dtype first; so does the port (bitwise)."""
    from msrflute_tpu.models.base import to_float_image as jax_to_float
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jax_to_float(jnp.asarray(x), getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = to_float_image(torch.from_numpy(x), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
