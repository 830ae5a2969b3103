"""CLI launcher — run a federated simulation of the port from a YAML config.

The counterpart of the repository's ``e2e_trainer.py``, with the same
flags plus ``-device``::

    python -m msrflute_tpu_torch.e2e_trainer -config cfg.yaml \\
        -dataPath ./data -outputPath ./out -task cv_cnn_femnist \\
        [-device cuda|cpu]

The run goes to ``cuda`` unless ``-device cpu`` is given; without a usable
card it stops with an error instead of running on the CPU.  Outputs:
``<out>/<config file>``, ``<out>/log/log.out``, ``<out>/log/metrics.jsonl``
and ``<out>/models/`` (``latest_model.pt``, ``best_val_<metric>_model.pt``,
``epoch<N>.pt``, ``status_log.json``; under ``server_config.type:
personalization`` also ``personalization/user<N>_model.pt``, one per user;
with ``server_config.dump_norm_stats``, ``norm_stats.txt`` and
``cosines.txt``).

A run stopped by SIGTERM or SIGINT, or by the drill
``server_config.chaos.preempt_at_round``, drains its rounds in flight,
writes a durable checkpoint and exits with ``os.EX_TEMPFAIL`` (75):
relaunch the same command with ``server_config.resume_from_checkpoint:
true`` to continue, bit for bit.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

import yaml

from .config import FLUTEConfig
from .device import resolve_device
from .engine import OptimizationServer, select_server
from .models import make_task
from .tasks import build_server_train_dataset, build_task_datasets
from .utils.logging import MetricsLog, init_logging, print_rank


def main(argv: Optional[Sequence[str]] = None) -> OptimizationServer:
    ap = argparse.ArgumentParser()
    ap.add_argument("-config", required=True)
    ap.add_argument("-dataPath", default=None)
    ap.add_argument("-outputPath", default="./output")
    ap.add_argument("-task", default=None)
    ap.add_argument("-num_skip_decoding", default=-1, type=int)  # parity arg
    ap.add_argument("-backend", default=None)  # parity arg, unused
    ap.add_argument("-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.outputPath, exist_ok=True)
    model_dir = os.path.join(args.outputPath, "models")
    log_dir = os.path.join(args.outputPath, "log")
    os.makedirs(model_dir, exist_ok=True)
    init_logging(log_dir)
    shutil.copyfile(args.config,
                    os.path.join(args.outputPath,
                                 os.path.basename(args.config)))

    with open(args.config) as fh:
        cfg = FLUTEConfig.from_dict(yaml.safe_load(fh))
    cfg.task = args.task or cfg.task
    cfg.data_path = args.dataPath or cfg.data_path
    cfg.output_path = args.outputPath
    cfg.validate(cfg.data_path)

    task = make_task(cfg.model_config)
    train_ds, val_ds, test_ds = build_task_datasets(cfg, task)
    print_rank(f"task={cfg.task} device={device} users={len(train_ds)} "
               f"val={len(val_ds) if val_ds else 0} "
               f"test={len(test_ds) if test_ds else 0}")
    metrics = MetricsLog(log_dir)
    try:
        server_cls = select_server(cfg.server_config.get("type"))
        server = server_cls(task, cfg, train_ds, val_dataset=val_ds,
                            test_dataset=test_ds, model_dir=model_dir,
                            device=device, metrics=metrics,
                            server_train_dataset=build_server_train_dataset(
                                cfg, task))
        server.train()
    finally:
        metrics.close()
    if server.preempted:
        # ``e2e_trainer.py:130-140``: schedulers re-queue on 75
        print_rank("exiting preempted (EX_TEMPFAIL); resume with "
                   "server_config.resume_from_checkpoint: true")
        raise SystemExit(os.EX_TEMPFAIL)
    return server


if __name__ == "__main__":
    main()
