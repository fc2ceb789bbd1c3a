"""Inference server of the port:

    python -m hirest_tpu_torch.serve --video_feature_dir feats/ \
        [--load BEST.pth] [--port 8080] [--device cpu]

The flags of the root serve.py, with `--device` ("cuda" by default; there
is no fallback to the CPU) and `--load` for a reference-format `.pth` joint
checkpoint. See hirest_tpu_torch/serve/server.py for the endpoints.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m hirest_tpu_torch.serve")
    p.add_argument("--video_feature_dir", required=True)
    p.add_argument("--asr_dir", default=None)
    p.add_argument("--asr_feature_dir", default=None)
    p.add_argument("--load", default=None,
                   help="a reference-format .pth joint checkpoint")
    p.add_argument("--pretrained_dir", default="./pretrained_weights")
    p.add_argument("--n_model_frames", type=int, default=-1)
    p.add_argument("--num_beams", type=int, default=3)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    a = p.parse_args(argv)
    if a.load and not a.load.endswith(".pth"):
        p.error("--load takes a reference-format .pth checkpoint")
    return a


def build_engine(a: argparse.Namespace):
    from hirest_tpu_torch.config import HirestConfig
    from hirest_tpu_torch.serve import ServingEngine

    config = HirestConfig(
        video_feature_dir=a.video_feature_dir, asr_dir=a.asr_dir,
        asr_feature_dir=a.asr_feature_dir, n_model_frames=a.n_model_frames,
        num_beams=a.num_beams, pretrained_dir=a.pretrained_dir,
        task_moment_retrieval=True, task_moment_segmentation=True,
        task_step_captioning=True, eval_batch_size=1, device=a.device)

    tokenizer = None
    vocab = os.path.join(a.pretrained_dir, "vocab.txt")
    if os.path.exists(vocab):
        from hirest_tpu_torch.tokenizers import WordPieceTokenizer

        tokenizer = WordPieceTokenizer(vocab)

    engine = ServingEngine(config, wordpiece_tokenizer=tokenizer)
    if a.load:
        engine.trainer.load_torch_checkpoint(a.load)
    return engine


def main(argv=None) -> None:
    from hirest_tpu_torch.serve import make_server

    a = parse_args(argv)
    engine = build_engine(a)
    if not a.no_warmup:
        print("warmup:", engine.warmup())
    server = make_server(engine, a.host, a.port)
    print(f"serving on http://{a.host}:{a.port} "
          f"({len(engine.video_ids)} indexed videos, "
          f"{engine.health()['devices'][0]})")
    server.serve_forever()


if __name__ == "__main__":
    main()
