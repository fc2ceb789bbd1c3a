"""Training and evaluation entry point of the port:

    python -m hirest_tpu_torch.run --train --data_dir splits/ \
        --video_feature_dir feats/ --task_moment_retrieval ... [--device cpu]

Counterpart of the root run.py, with the flags of the port's `get_parser`
(the reference's, plus `--device`: "cuda" by default, with no fallback to
the CPU). `--train` trains and scores the test split with BEST;
`--end_to_end` runs the staged pipeline over the test split; otherwise
each task's test predictions go to `{ckpt_dir}/test_{task}_BEST.json`.
`--load` takes a checkpoint of the port (`.pt`, with its optimizer state)
or a reference-format `.pth`.

`--mesh_shape data:N[,model:M]` trains and predicts over N x M ranks, one
device each (parallel/mesh.py), launched by torchrun:

    torchrun --standalone --nproc_per_node=N -m hirest_tpu_torch.run \
        --train --mesh_shape data:N ... [--device cpu]

Each rank runs on cuda:{LOCAL_RANK} over NCCL, or with `--device cpu` on
the CPU over gloo; rank 0 writes the JSONs and checkpoints.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from hirest_tpu_torch.config import HirestConfig


def main(argv=None) -> None:
    config = HirestConfig.from_args(argv)
    main_rank = True
    if config.mesh_shape:
        from hirest_tpu_torch.parallel.mesh import init_distributed

        config.device = str(init_distributed(
            device=None if config.device == "cuda" else config.device))
        main_rank = int(os.environ.get("RANK", 0)) == 0
    random.seed(config.seed)
    np.random.seed(config.seed)
    torch.manual_seed(config.seed)
    if main_rank:
        print(config.to_json())

    tokenizer = None
    vocab_path = os.path.join(config.pretrained_dir, "vocab.txt")
    if os.path.exists(vocab_path):
        from hirest_tpu_torch.tokenizers import WordPieceTokenizer

        tokenizer = WordPieceTokenizer(vocab_path)
    else:
        print(f"WARNING: {vocab_path} not found - step captions will be "
              f"raw ids")

    from hirest_tpu_torch.train.trainer import Trainer

    trainer = Trainer(config, wordpiece_tokenizer=tokenizer)
    if config.load is not None:
        if config.load.endswith(".pth"):
            trainer.load_torch_checkpoint(config.load)
        else:
            trainer.load(config.load)

    if config.end_to_end:
        from hirest_tpu_torch.infer.pipeline import run_end_to_end

        run_end_to_end(trainer)
    elif config.train:
        trainer.train()
    elif "test" in trainer.loaders:
        os.makedirs(config.ckpt_dir, exist_ok=True)
        for task in config.tasks:
            res = trainer.evaluate(trainer.loaders["test"][task], task,
                                   has_target=False)
            if not main_rank:
                continue
            out = os.path.join(config.ckpt_dir, f"test_{task}_BEST.json")
            with open(out, "w") as f:
                json.dump(res, f, indent=4)
            print("Saved", out)


if __name__ == "__main__":
    main()
