#!/usr/bin/env python3
"""Does a client's update depend on the vmap width it trains at?

    python3 msrflute_tpu_torch/csrc/probes/vmap_width.py [cpu|cuda]

Cohort bucketing and the megabatch lane scan train a client on grids of
other widths than the monolithic round's, so a client's payload is bitwise
across grid shapes only where the per-client math does not depend on the
width.  This prints one JSON object (default device ``cuda``):

- ``<model>_grad_width``: for CNN_FEMNIST (28x28x1, 62 classes) and LR
  (784 -> 10), the largest difference of each leaf's gradient between a
  width-10 ``vmap(grad)`` and widths 3, 1 and 7 on the same rows;
- ``<model>_lane_L<n>_*``: the lane scan (``build_mega_update``) at 4 and
  10 lanes against the width-10 vmap arm, 4 local steps with dropout;
- ``<model>_subgrid_pg_maxdiff``: three rows on a 1-step, 3-row grid;
- ``cnn_sensitivity``: relative L2 of four clients' payloads (2, 3, 15 and
  2 local steps at batch 20) when the start moves by 1e-7 x N(0, 1).

Nothing imports it; run it from the repository's root.
"""

import json
import sys

import numpy as np
import torch
from torch.func import grad_and_value, vmap

sys.path.insert(0, ".")

from msrflute_tpu_torch.config import ModelConfig, OptimizerConfig  # noqa: E402
from msrflute_tpu_torch.data.batching import plan_megabatch  # noqa: E402
from msrflute_tpu_torch.device import resolve_device  # noqa: E402
from msrflute_tpu_torch.engine.client_update import (  # noqa: E402
    ClientHParams, build_client_update, build_mega_update)
from msrflute_tpu_torch.models import make_task  # noqa: E402

MODELS = {"cnn": {"model_type": "CNN", "num_classes": 62, "image_size": 28},
          "lr": {"model_type": "LR", "num_classes": 10, "input_dim": 784}}


def widths(name, task, flat, dev, out):
    lay = task.layout()
    rng = np.random.default_rng(0)
    K, B, S = 10, 20, 4
    x = torch.from_numpy(rng.integers(0, 255, size=(K, B, 28, 28)).astype(
        np.uint8)).to(dev)
    if name == "lr":
        x = x.reshape(K, B, 784).float()
    y = torch.from_numpy(rng.integers(0, 10, size=(K, B)).astype(
        np.int32)).to(dev)
    m = torch.ones(K, B, device=dev)
    params = flat.expand(K, -1).clone()
    gf = vmap(grad_and_value(task.loss_and_aux, has_aux=True))
    masks = tuple(torch.ones((K, B) + tuple(s), dtype=torch.bool, device=dev)
                  for _, s in task.dropout_sites)
    g10, _ = gf(lay.views(params), {"x": x, "y": y, "sample_mask": m}, masks)
    res = {}
    for idx in ([1, 3, 4], [2], [0, 1, 2, 3, 4, 5, 6]):
        gi, _ = gf(lay.views(params[idx]),
                   {"x": x[idx], "y": y[idx], "sample_mask": m[idx]},
                   tuple(mm[idx] for mm in masks))
        res[len(idx)] = {n: float((g10[n][idx] - gi[n]).abs().max())
                         for n in g10}
    out[f"{name}_grad_width"] = res
    xs = torch.from_numpy(rng.integers(0, 255, size=(K, S, B, 28, 28)).astype(
        np.uint8)).to(dev)
    if name == "lr":
        xs = xs.reshape(K, S, B, 784).float()
    ys = torch.from_numpy(rng.integers(0, 10, size=(K, S, B)).astype(
        np.int32)).to(dev)
    needs = [1, 2, 1, 3, 1, 1, 2, 1, 1, 2]
    sm = torch.zeros(K, S, B, device=dev)
    for k, n in enumerate(needs):
        sm[k, :n] = 1
    opt = OptimizerConfig.from_dict({"type": "sgd", "lr": 0.1})
    hp = ClientHParams()

    def gens():
        return ([torch.Generator(device=dev).manual_seed(9 + k)
                 for k in range(K)] if task.draws_random else None)

    arrays = {"x": xs, "y": ys}
    ref = build_client_update(task, opt, hp)(flat, arrays, sm, 0.1, gens())
    mega = build_mega_update(task, opt, hp)
    for lanes in (4, 10):
        (rows, tape), = plan_megabatch(needs, 1, lanes, S, 1, K)
        got = mega(flat, arrays, sm, 0.1, gens(), tape=tape, tape_dev=(
            torch.from_numpy(tape.ptr).to(dev),
            torch.from_numpy(tape.seg).to(dev)))
        out[f"{name}_lane_L{lanes}_pg_maxdiff"] = float(
            (got[0] - ref[0]).abs().max())
        out[f"{name}_lane_L{lanes}_bitwise"] = bool(torch.equal(got[0],
                                                                ref[0]))
    sub = [0, 2, 5]
    sref = build_client_update(task, opt, hp)(
        flat, {"x": xs[sub][:, :1], "y": ys[sub][:, :1]}, sm[sub][:, :1],
        0.1, None if gens() is None else [gens()[k] for k in sub])
    out[f"{name}_subgrid_pg_maxdiff"] = float(
        (sref[0] - ref[0][sub]).abs().max())


def sensitivity(task, flat, dev):
    """Four clients of a log-uniform pool (chip_smoke's throughput pool)
    trained 2-15 steps from ``flat`` and from ``flat`` moved by 1e-7."""
    rng = np.random.default_rng(21)
    sizes = np.rint(np.exp(rng.uniform(np.log(20), np.log(1200), 200)))
    data = np.random.default_rng(21)
    pool = [(data.integers(0, 256, size=(int(n), 28, 28, 1), dtype=np.uint8),
             data.integers(0, 62, size=int(n)).astype(np.int32))
            for n in sizes]
    ids, S, B = [3, 10, 50, 77], 16, 20
    x = np.zeros((4, S * B, 28, 28, 1), np.uint8)
    y = np.zeros((4, S * B), np.int32)
    mask = np.zeros((4, S * B), np.float32)
    for j, c in enumerate(ids):
        order = np.random.default_rng(c).permutation(len(pool[c][1]))
        take = order[:S * B]
        x[j, :len(take)], y[j, :len(take)] = pool[c][0][take], pool[c][1][take]
        mask[j, :len(take)] = 1.0
    arrays = {"x": torch.from_numpy(x.reshape(4, S, B, 28, 28, 1)).to(dev),
              "y": torch.from_numpy(y.reshape(4, S, B)).to(dev)}
    sm = torch.from_numpy(mask.reshape(4, S, B)).to(dev)
    update = build_client_update(
        task, OptimizerConfig.from_dict({"type": "sgd", "lr": 0.1}),
        ClientHParams())

    def gens():
        return [torch.Generator(device=dev).manual_seed(c) for c in ids]

    pg = update(flat, arrays, sm, 0.1, gens())[0]
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=flat.shape).astype(np.float32)).to(dev) * 1e-7
    pg2 = update(flat + noise, arrays, sm, 0.1, gens())[0]
    steps = [int(np.ceil(min(sizes[c], S * B) / B)) for c in ids]
    return {"clients": ids, "local_steps": steps,
            "rel_l2": [float((pg2[j] - pg[j]).norm() / pg[j].norm())
                       for j in range(4)]}


def main() -> int:
    dev = resolve_device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    out = {"device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                      else "cpu"), "torch": torch.__version__}
    for name, mc in MODELS.items():
        task = make_task(ModelConfig.from_dict(mc))
        flat = task.layout().flatten(task.init_params(0)).to(dev)
        widths(name, task, flat, dev, out)
        if name == "cnn":
            out["cnn_sensitivity"] = sensitivity(task, flat, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
