"""The port's ResNet-18-GN task (``msrflute_tpu_torch/models/resnet.py``)
against the JAX package's ``models/resnet.py``, on weights carried across by
``models/convert.py``, at the real stage widths (64-512) on 12x12 images.

Tolerances: logits, loss and gradients to ``rtol 1e-4`` of the largest
entry (20 convolutions and 21 GroupNorms reduce in other orders in the two
frameworks; GroupNorm's variance is the mean of squared deviations in
PyTorch and ``E[x^2] - E[x]^2`` in flax, which agree to float32 rounding on
inputs of unit scale).  The GroupNorm scales and biases are drawn at random
so that every block's residual branch is live (at init the block-final
scales are zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu_torch.config import FLUTEConfig, ModelConfig
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params

SMALL = {"model_type": "RESNET", "num_classes": 10, "image_size": 12,
         "channels_per_group": 16}
RTOL = 1e-4


def _tasks(raw):
    extra = {k: v for k, v in raw.items() if k != "model_type"}
    jt = jax_make_task(JaxModelConfig(model_type=raw["model_type"],
                                      extra=dict(extra)))
    pt = make_task(ModelConfig(model_type=raw["model_type"],
                               extra=dict(extra)))
    return jt, pt


def _live_params(jt, seed=3):
    """JAX init with every GroupNorm scale and bias redrawn."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(jax.jit(jt.init_params)(
        jax.random.PRNGKey(seed)))

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "GroupNorm" in name and "scale" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "GroupNorm" in name and "bias" in name:
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(n=2, side=12, seed=0, chans=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, 256, (n, side, side, chans)).astype(np.uint8),
            "y": rng.integers(0, 10, (n,)).astype(np.int32),
            "sample_mask": np.ones((n,), np.float32)}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def setup():
    jt, pt = _tasks(SMALL)
    jp = _live_params(jt)
    return jt, pt, jp, from_jax_params(pt, jp)


def test_logits_loss_and_eval_match(setup):
    jt, pt, jp, tp = setup
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    _close(pt.apply(tp, tb["x"]).detach().numpy(),
           jax.jit(jt.apply)(jp, jb["x"]))
    jl, _ = jax.jit(lambda p, b: jt.loss(p, b, None, train=False))(jp, jb)
    assert float(pt.loss_masked(tp, tb)) == pytest.approx(float(jl),
                                                          rel=RTOL)
    js, ts = jax.jit(jt.eval_stats)(jp, jb), pt.eval_stats(tp, tb)
    assert set(js) == set(ts)
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=RTOL)


def test_grads_match(setup):
    jt, pt, jp, tp = setup
    b = _batch(seed=1)
    jg = jax.jit(jax.grad(lambda p: jt.loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, None,
        train=False)[0]))(jp)
    tg = grad(pt.loss_masked)(tp, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    want = from_jax_params(pt, jax.device_get(jg))
    assert set(tg) == set(want)
    for k in want:
        _close(tg[k].numpy(), want[k].numpy())


def test_clients_under_vmap_equal_one_at_a_time(setup):
    """The client update takes ``vmap(grad)`` over K clients: the batched
    convolutions and GroupNorms give each client its own gradient."""
    _, pt, _, tp = setup
    K = 3
    params = {k: torch.stack([v * (1.0 + 0.1 * i) for i in range(K)])
              for k, v in tp.items()}
    batches = [_batch(seed=10 + i) for i in range(K)]
    stacked = {k: torch.stack([torch.from_numpy(b[k]) for b in batches])
               for k in batches[0]}
    fn = grad_and_value(pt.loss_and_aux, has_aux=True)
    gv, (lv, _) = vmap(fn)(params, stacked)
    for i in range(K):
        g1, (l1, _) = fn({k: v[i] for k, v in params.items()},
                         {k: torch.from_numpy(v) for k, v in
                          batches[i].items()})
        assert float(lv[i]) == pytest.approx(float(l1), rel=1e-6)
        for k in g1:
            _close(gv[k][i].numpy(), g1[k].numpy(), rtol=1e-5)


def test_weight_carry_across_round_trips(setup):
    _, pt, jp, tp = setup
    back = to_jax_params(tp)
    flat = dict(jax.tree_util.tree_leaves_with_path(jp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == \
        set(map(jax.tree_util.keystr, got))
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, np.asarray(flat[path]))
    assert [n for n, _ in pt.param_spec()] == list(tp)


@pytest.mark.parametrize("depth,params", [(18, 11_227_812),
                                          (34, 21_335_972)])
def test_published_widths_have_the_jax_parameter_count(depth, params):
    """``experiments/cv_resnet_fedcifar100/config.yaml`` (100 classes, 16
    channels a group): P = 11,227,812 at depth 18, kernel B1's row width
    on this path; every leaf's shape as ``jax.eval_shape`` gives it."""
    raw = {"model_type": "RESNET", "depth": depth, "num_classes": 100,
           "image_size": 32, "channels_per_group": 16}
    jt, pt = _tasks(raw)
    shapes = jax.eval_shape(jt.init_params, jax.random.PRNGKey(0))
    assert pt.layout().numel == params == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {k: tuple(v.shape) for k, v in from_jax_params(pt, zeros).items()}
    assert want == dict(pt.param_spec())


def test_init_follows_the_jax_initializers():
    """He fan-out normal convolutions, GroupNorm scales one except each
    block's final norm (zero), biases zero; the first block starts as the
    identity."""
    _, pt = _tasks(SMALL)
    p = pt.init_params(0)
    w = p["_BasicBlock_4.Conv_1.weight"]              # 3x3, 256 -> 256
    assert float(w.std()) == pytest.approx((2.0 / (256 * 9)) ** 0.5,
                                           rel=0.02)
    assert float(p["_BasicBlock_4.GroupNorm_1.scale"].abs().max()) == 0.0
    assert float(p["_BasicBlock_4.GroupNorm_0.scale"].min()) == 1.0
    assert float(p["_BasicBlock_4.GroupNorm_2.bias"].abs().max()) == 0.0
    assert not any(n.endswith("Conv_0.bias") for n in p)
    x = torch.randn(2, 64, 3, 3)
    block = pt.module._BasicBlock_0
    from torch.func import functional_call
    sub = {k[len("_BasicBlock_0."):]: v for k, v in p.items()
           if k.startswith("_BasicBlock_0.")}
    torch.testing.assert_close(functional_call(block, sub, (x,)),
                               torch.relu(x))


@pytest.mark.parametrize("depth", [50, 0])
def test_other_depths_are_refused(depth):
    raw = {"model_config": dict(SMALL, depth=depth),
           "server_config": {}, "client_config": {}}
    with pytest.raises(ValueError, match="depth"):
        FLUTEConfig.from_dict(raw)
