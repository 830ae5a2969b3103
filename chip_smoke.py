#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, ``nvcc`` and no
network.  Phases, each printing one JSON line (any failure exits non-zero
and prints no result):

1. ``env``    — the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions; then ``build``: every kernel of the port compiled
   from ``msrflute_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together), with the build time and ``ptxas`` report.
2. ``kernel`` — each kernel against its plain PyTorch version on the card,
   at the main path's shape and at odd shapes, with mixed per-row gates:
   bitwise equal.  Then kernel, plain and library-call times at the main
   path's shape, beside the least time the card could take (``bound_ms``).
3. ``main``   — the FedAvg CNN_FEMNIST main path through the port's CLI
   (``msrflute_tpu_torch.e2e_trainer``, in process) on ``cuda``, at the
   published ``cv_cnn_femnist`` widths (10 clients a round, batch 20,
   client SGD lr 0.1, server SGD lr 1.0, dropout on) with
   ``megakernel.pallas_apply: true``, 5 rounds.  The data is a synthetic
   FEMNIST-shaped user blob (28x28x1 uint8, 62 classes) of 350 writers
   with 50-300 samples each: FEMNIST's population of 3,400 writers cut to
   a tenth, so it generates in seconds.  Asserts the kernel ran on every
   local step, losses are finite, and the checkpoint and status log exist.
   ``profile`` then times three more rounds of the same engine on the host
   clock and three under ``torch.profiler``: wall time and device time per
   round, the device's idle share, and the kernels that take the most
   device time.
4. ``cross_device`` — 2 rounds of the same config with dropout off, twice
   on ``cuda`` (kernel) and once on ``cpu`` (plain version): the two cuda
   runs are bitwise equal, and the params after each round agree with the
   cpu run within ``CROSS_TOL`` (cuDNN and the CPU reduce convolutions in
   different orders).

The line before the last is the ``kernels`` table (launches on the main
path, ``max_abs_err``, ``ms``, ``plain_ms``, ``bound_ms``, ``library_ms``);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
#: and float32 (non-tensor-core) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: the main path's kernel shape: K = 10 clients x P = CNN_FEMNIST params
MAIN_K, MAIN_P = 10, 1_206_590

CNN_CONFIG = {
    "model_config": {"model_type": "CNN", "num_classes": 62,
                     "image_size": 28},
    "strategy": "fedavg",
    "server_config": {
        "max_iteration": 5,
        "num_clients_per_iteration": 10,
        "initial_lr_client": 0.1,
        "val_freq": 2,
        "rec_freq": 5,
        "initial_val": True,
        "best_model_criterion": "acc",
        "model_backup_freq": 500,
        "rounds_per_step": 25,
        "optimizer_config": {"type": "sgd", "lr": 1.0},
        "megakernel": {"pallas_apply": True},
        "data_config": {
            "val": {"batch_size": 2048, "val_data": "femnist/val.json"},
            "test": {"batch_size": 2048, "test_data": "femnist/test.json"}},
    },
    "client_config": {
        "optimizer_config": {"type": "sgd", "lr": 0.1},
        "data_config": {"train": {"batch_size": 20,
                                  "list_of_train_data":
                                      "femnist/train.json"}},
    },
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ----------------------------------------------------------------------
def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    check(bool(card), f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    emit({"phase": "env", "ok": True, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    return card


def phase_build():
    from msrflute_tpu_torch.ops import _build
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    tic = time.time()
    logs = _build.build(sources)
    emit({"phase": "build", "ok": True, "kernels": sources,
          "seconds": round(time.time() - tic, 3),
          "ptxas": {k: [line for line in v.splitlines()
                        if "registers" in line or "spill" in line]
                    for k, v in logs.items()}})


def _sgd_inputs(torch, K, P, gate, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p, g, m = (torch.randn((K, P), generator=gen, device="cuda")
               for _ in range(3))
    return p, g, m, torch.tensor(gate, dtype=torch.float32, device="cuda")


def _time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(torch):
    """B1 against its plain version: bitwise, then timed."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    lr = 0.1
    cases = [(MAIN_K, MAIN_P, [1, 0, 1, -1, 1, 1, 0, 1, 1, 1]),
             (MAIN_K, MAIN_P, [1] * MAIN_K),
             (3, 1, [1, 0, 1]), (4, 127, [0, 1, -2, 1]),
             (5, 1000, [1, 1, 0, 1, 1]), (2, 1_048_579, [1, 0])]
    max_err = 0.0
    for K, P, gate in cases:
        for mu in (0.0, 0.9):
            p, g, m, gt = _sgd_inputs(torch, K, P, gate, seed=K * 7 + P)
            kp, km = p.clone(), m.clone()
            pp, pm = p.clone(), m.clone()
            fused_sgd_apply(kp, g, km, lr, mu, gt)
            fused_sgd_plain(pp, g, pm, lr, mu, gt)
            torch.cuda.synchronize()
            err = max(float((kp - pp).abs().max()),
                      float((km - pm).abs().max()))
            if (K, P) == (MAIN_K, MAIN_P):
                max_err = max(max_err, err)
            check(torch.equal(kp, pp) and torch.equal(km, pm),
                  f"fused_sgd [{K}, {P}] mu={mu}: kernel != plain "
                  f"(max abs err {err})")
            dead = [k for k, v in enumerate(gate) if v <= 0]
            check(all(torch.equal(kp[k], p[k]) and torch.equal(km[k], m[k])
                      for k in dead), "gated rows were written")

    # timing at the main path's shape, every row live (the library call
    # has no per-row gate)
    mu = 0.9
    p, g, m, gt = _sgd_inputs(torch, MAIN_K, MAIN_P, [1] * MAIN_K, seed=1)
    kernel_ms = _time_ms(torch, lambda: fused_sgd_apply(p, g, m, lr, mu, gt))
    plain_ms = _time_ms(torch, lambda: fused_sgd_plain(p, g, m, lr, mu, gt))
    library_ms = _time_ms(torch, lambda: torch._fused_sgd_(
        [p], [g], [m], weight_decay=0.0, momentum=mu, lr=lr, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False))
    kernel_ms_2 = _time_ms(torch, lambda: fused_sgd_apply(p, g, m, lr, mu,
                                                          gt))
    n = MAIN_K * MAIN_P
    nbytes = 20 * n + 4 * MAIN_K          # read p, g, m, gate; write p, m
    bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                   4 * n / PEAK_F32_FLOPS) * 1e3
    row = {"name": "fused_sgd_apply", "route": "cuda",
           "source": "msrflute_tpu_torch/csrc/fused_sgd.cu",
           "replaces": "msrflute_tpu/ops/pallas_kernels.py:212",
           "launches": None, "max_abs_err": max_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": library_ms}
    emit({"phase": "kernel", "ok": True, "name": "fused_sgd_apply",
          "cases": len(cases) * 2, "bitwise": True, "shape": [MAIN_K, MAIN_P],
          "ms": kernel_ms, "ms_repeat": kernel_ms_2, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes,
          "achieved_gb_s": nbytes / (kernel_ms * 1e-3) / 1e9})
    return row


# ----------------------------------------------------------------------
def write_femnist_blob(path, num_users, lo, hi, seed):
    """A FEMNIST-shaped user blob: 28x28 uint8 images, 62 classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = [f"f{seed}_{i:04d}" for i in range(num_users)]
    counts = rng.integers(lo, hi + 1, size=num_users).tolist()
    data, labels = {}, {}
    for u, n in zip(users, counts):
        data[u] = {"x": rng.integers(0, 256, size=(n, 28, 28),
                                     dtype=np.uint8).tolist()}
        labels[u] = rng.integers(0, 62, size=n).tolist()
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)
    return sum(counts)


def _run_cli(work, name, raw, device):
    import yaml
    from msrflute_tpu_torch import e2e_trainer
    cfg_path = os.path.join(work, f"{name}.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(raw, fh)
    out = os.path.join(work, f"out_{name}")
    tic = time.time()
    server = e2e_trainer.main(["-config", cfg_path, "-dataPath", work,
                               "-outputPath", out, "-task",
                               "cv_cnn_femnist", "-device", device])
    return server, out, time.time() - tic


def phase_main(torch, work, kernel_rows):
    import numpy as np
    from msrflute_tpu_torch.ops import KERNELS
    os.makedirs(os.path.join(work, "femnist"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_femnist_blob(
        os.path.join(work, "femnist", f"{split}.json"), users, 50, 300, seed)
        for split, users, seed in (("train", 350, 0), ("val", 35, 1),
                                   ("test", 35, 2))}
    blob_s = time.time() - tic

    for wrapper in KERNELS.values():
        wrapper.launches = 0
    server, out, secs = _run_cli(work, "main", CNN_CONFIG, "cuda")
    launches = {name: w.launches for name, w in KERNELS.items()}

    check(server.state.params.is_cuda, "server params are not on cuda")
    check(all(t.is_cuda for t in server.state.opt_state.values()),
          "server optimizer state is not on cuda")
    steps = server.engine.local_steps
    check(launches["fused_sgd_apply"] == steps > 0,
          f"fused_sgd_apply launched {launches['fused_sgd_apply']} times "
          f"for {steps} local steps")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    with open(os.path.join(out, "log", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train_loss = [r["value"] for r in records if r.get("name") ==
                  "Training loss"]
    check(len(train_loss) == 5 and all(map(math.isfinite, train_loss)),
          f"training losses {train_loss}")
    evals = [h for h in server.history]
    check(all(math.isfinite(h["loss"]) for h in evals),
          f"non-finite eval loss: {evals}")
    models = os.path.join(out, "models")
    for f in ("latest_model.pt", "latest_model.pt.sum", "status_log.json",
              "best_val_acc_model.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    with open(os.path.join(models, "status_log.json")) as fh:
        check(json.load(fh)["i"] == 5, "status_log.json is not at round 5")
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    rounds = server.run_stats["secsPerRound"]
    val = [h for h in evals if h["split"] == "val"]
    emit({"phase": "main", "ok": True, "device": "cuda",
          "users": {"train": 350, "val": 35, "test": 35},
          "samples": sizes, "population_note":
              "FEMNIST's 3,400 writers cut to 350 (synthetic data)",
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(rounds), "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "local_steps": steps, "launches": launches,
          "train_loss": train_loss,
          "val": [{"round": h["round"], "loss": h["loss"], "acc": h["acc"]}
                  for h in val]})
    return server


def phase_profile(torch, server, rounds=3):
    """Where a main-path round's time goes: on one fresh cohort, after one
    warm-up round, ``rounds`` rounds of the main run's engine timed on the
    host clock, then ``rounds`` more under ``torch.profiler`` for the time
    each kernel (and copy) runs on the device.  The idle share is the part
    of the untraced round in which the device runs nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    batch = pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)
    engine, state = server.engine, server.state
    state, _ = engine.run_round(state, batch, 0.1, 1.0)
    torch.cuda.synchronize()
    tic = time.time()
    for _ in range(rounds):
        state, _ = engine.run_round(state, batch, 0.1, 1.0)
    torch.cuda.synchronize()
    wall_ms = (time.time() - tic) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            state, _ = engine.run_round(state, batch, 0.1, 1.0)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3 / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "ok": True, "rounds": rounds,
          "steps_per_round": int(batch.sample_mask.shape[1]),
          "wall_ms_per_round": wall_ms,
          "device_ms_per_round": device_ms if by_name else None,
          "device_idle_share": (1.0 - device_ms / wall_ms) if by_name
          else None,
          "top_device_ops": [{"name": k[:80], "ms_per_round": us / 1e3 / rounds,
                              "calls_per_round": n / rounds}
                             for k, (us, n) in top]})


#: cuda vs cpu, relative L2 of the params after round 1 and round 2.  Only
#: the reduction order differs (cuDNN vs the CPU's convolutions), and the
#: 15 local SGD steps a round on random labels grow that difference about
#: fortyfold a round: this phase measured 4.6e-5 after round 1 and 2.1e-3
#: after round 2 on an H100.  The bounds leave about tenfold room.
CROSS_TOL = {1: 5e-4, 2: 2e-2}


def phase_cross_device(torch, work):
    """The same 2 rounds, dropout off, on cuda twice (kernel) and on cpu
    (plain version): cuda is bitwise reproducible, and cuda agrees with cpu
    within :data:`CROSS_TOL` after each round."""
    raw = json.loads(json.dumps(CNN_CONFIG))
    raw["model_config"].update(dropout1=0.0, dropout2=0.0)
    raw["server_config"].update(max_iteration=2, val_freq=100, rec_freq=100,
                                initial_val=False, rounds_per_step=1,
                                model_backup_freq=1)
    params, secs = {}, {}
    for tag, device in (("cuda", "cuda"), ("cuda_again", "cuda"),
                        ("cpu", "cpu")):
        server, _, secs[tag] = _run_cli(work, f"cross_{tag}", raw, device)
        params[tag] = [server.ckpt.load(torch.device("cpu"),
                                        f"epoch{r}.pt").params.double()
                       for r in CROSS_TOL]
    check(all(torch.equal(a, b) for a, b in zip(params["cuda"],
                                                params["cuda_again"])),
          "two cuda runs of one config differ")
    rel = {}
    for r, a, b in zip(CROSS_TOL, params["cuda"], params["cpu"]):
        rel[r] = float((a - b).norm() / b.norm())
        check(rel[r] <= CROSS_TOL[r],
              f"cuda vs cpu params after round {r}: rel L2 {rel[r]} > "
              f"{CROSS_TOL[r]}")
    emit({"phase": "cross_device", "ok": True, "rounds": 2,
          "cuda_reproducible": True,
          "rel_l2_by_round": rel, "tolerance_rel_l2_by_round": CROSS_TOL,
          "seconds": {k: round(v, 3) for k, v in secs.items()}})


# ----------------------------------------------------------------------
def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "msrflute_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(msrflute_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this test needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    phase = "env"
    try:
        phase_env(torch)
        phase = "build"
        phase_build()
        phase = "kernel"
        rows = [phase_kernel(torch)]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            phase = "main"
            server = phase_main(torch, work, rows)
            phase = "profile"
            phase_profile(torch, server)
            phase = "cross_device"
            phase_cross_device(torch, work)
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        import traceback
        traceback.print_exc()
        return 1
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
