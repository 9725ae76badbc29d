#!/usr/bin/env python3
"""The JAX package's reading of the img_fit run that chip_smoke.py's phase
12 (a) repeats on the card, on the CPU.

    JAX_PLATFORMS=cpu python scripts/img_fit_jax_reference.py [--write_init]

configs/img_fit/lego_view0.yaml as committed (D 4, W 128, 10 bands,
N_pixels 8192, Adam 5e-4, exponential decay, test at input_ratio 0.5), with
``data_root`` a scratch directory, ``scene`` hard (one 800x800 train view
that the JAX package's ``generate_scene`` writes), ``train_dataset.seed``
and 2 epochs of 500 steps, starting from the Flax init of ``seed`` 0 saved
as data/pretrain/img_fit_init/pretrain.ckpt (``--write_init`` writes it
with ``save_pretrain``; without it the committed file is read). The loop
is train.py's host-loader path: ``make_data_loader`` and
``Trainer.train``, then ``Trainer.val`` with the img_fit evaluator after
each epoch. Prints one JSON line: the float PSNR at each epoch end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCENE = "hard"
SIZE = 800
DATA_SEED = 0
EPOCHS = 2
INIT_DIR = os.path.join("data", "pretrain", "img_fit_init")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--write_init", action="store_true")
    args = parser.parse_args(argv)
    os.chdir(ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.datasets.make_dataset import make_dataset
    from nerf_replication_tpu.evaluators import make_evaluator
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.train import make_recorder, make_trainer
    from nerf_replication_tpu.utils.ckpt_utils import (
        load_pretrain,
        save_pretrain,
    )
    from nerf_replication_tpu.utils.synthetic_scene import generate_scene

    tmp = tempfile.mkdtemp(prefix="img_fit_jax_")
    t0 = time.time()
    generate_scene(tmp, SCENE, H=SIZE, W=SIZE, n_train=1,
                   n_val=0, n_test=0)
    print(f"scene written in {time.time() - t0:.1f} s", file=sys.stderr)

    cfg = load_cfg_tree("configs/img_fit/lego_view0.yaml", default_cfg())
    cfg.scene = SCENE
    cfg.train_dataset.data_root = tmp
    cfg.test_dataset.data_root = tmp
    cfg.train_dataset.seed = DATA_SEED
    cfg.train.epoch = EPOCHS
    cfg.trained_model_dir = os.path.join(tmp, "model")
    cfg.record_dir = os.path.join(tmp, "record")
    cfg.result_dir = os.path.join(tmp, "result")

    network = make_network(cfg)
    if args.write_init:
        sample = make_dataset(cfg, is_train=True)[0]
        params = network.init(jax.random.key(int(cfg.seed)), sample)
        save_pretrain(params, "img_fit", model_dir=INIT_DIR)
    params = load_pretrain(INIT_DIR)
    trainer = make_trainer(cfg, network)
    recorder = make_recorder(cfg)
    evaluator = make_evaluator(cfg)
    state = trainer.init_state(params)
    loader = make_data_loader(cfg, is_train=True, max_iter=cfg.ep_iter)
    val_loader = make_data_loader(cfg, is_train=False)
    psnrs = []
    t0 = time.time()
    for epoch in range(EPOCHS):
        state = trainer.train(epoch, loader, state, recorder)
        psnrs.append(trainer.val(epoch, val_loader, state, evaluator)["psnr"])
    print(json.dumps({"scene": SCENE, "size": SIZE,
                      "data_seed": DATA_SEED, "steps": int(state["step"]),
                      "eval_psnr": psnrs, "train_s": time.time() - t0,
                      "device": "cpu (JAX package)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
