"""Custom-video end-to-end CLI of the port (the custom_video_pipeline
notebook as a script): one video + one prompt -> hierarchical
moments/segments/captions.

    python -m hirest_tpu_torch.pipeline_custom_video \
        --video path/to/video.mp4 --prompt "Make oatmeal pancakes" \
        [--load BEST.pth] [--extract_asr] [--work_dir out/] [--device cpu]

The flags of the root pipeline_custom_video.py, with `--device` ("cuda" by
default, with no fallback to the CPU). `--load` takes a checkpoint of the
port (`.pt`) or a reference-format `.pth`.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m hirest_tpu_torch.pipeline_custom_video")
    p.add_argument("--video", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--load", default=None)
    p.add_argument("--work_dir", default=None)
    p.add_argument("--extract_asr", action="store_true")
    p.add_argument("--pretrained_dir", default="./pretrained_weights")
    p.add_argument("--num_beams", type=int, default=3)
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    a = p.parse_args(argv)

    from hirest_tpu_torch.utils.device import resolve_device

    resolve_device(a.device)  # before any work: no fallback to the CPU

    from hirest_tpu_torch.config import HirestConfig
    from hirest_tpu_torch.infer.custom_video import run_custom_video

    config = HirestConfig(
        task_moment_retrieval=True, task_moment_segmentation=True,
        task_step_captioning=True, end_to_end=True, load=a.load,
        num_beams=a.num_beams, pretrained_dir=a.pretrained_dir,
        eval_batch_size=1, ckpt_dir=a.work_dir or "./custom_video_out",
        device=a.device)

    tokenizer = None
    vocab = os.path.join(a.pretrained_dir, "vocab.txt")
    if os.path.exists(vocab):
        from hirest_tpu_torch.tokenizers import WordPieceTokenizer

        tokenizer = WordPieceTokenizer(vocab)

    result = run_custom_video(a.video, a.prompt, config,
                              wordpiece_tokenizer=tokenizer,
                              work_dir=a.work_dir, extract_asr=a.extract_asr)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
