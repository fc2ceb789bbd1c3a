"""Configuration of the port.

Own copies of hirest_tpu/config.py's model configs (`EvaVisionConfig`,
`EvaTextConfig`, `VisualEncoderConfig`, `DecoderConfig`,
`JointModelConfig`), its run configuration `HirestConfig` and `get_parser`
(the port imports nothing of the JAX package). Field names, flags and
defaults are the same, so one set of values describes the same model in
both packages; `device` alone reads "cuda" (the default) or "cpu".
`heads_override` is set by the padded-heads transform (models/eva_pad.py),
which widens each head and keeps the count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class EvaVisionConfig:
    """EVA-CLIP-g vision tower (reference EVA_clip/model_configs/EVA_CLIP_g_14.json)."""

    image_size: int = 224
    layers: int = 40
    width: int = 1408
    head_width: int = 88
    mlp_ratio: float = 4.3637
    patch_size: int = 14
    embed_dim: int = 1024  # output projection dim
    norm_eps: float = 1e-6
    heads_override: Optional[int] = None  # set when head_width is padded

    @property
    def num_heads(self) -> int:
        if self.heads_override is not None:
            return self.heads_override
        return self.width // self.head_width

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class EvaTextConfig:
    """EVA-CLIP-g text tower (reference EVA_clip/eva_model.py:177-250)."""

    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 1024
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class VisualEncoderConfig:
    """BERT-style visual encoder (reference clip4caption/modules/visual-base/visual_config.json
    + runtime overrides in modeling.py:102-110 and args.py:53)."""

    feature_dim: int = 512            # "vocab_size" in the reference config: input Linear in-dim
    hidden_size: int = 768
    num_hidden_layers: int = 2        # visual_config.json says 1; args.py:53 overrides to 2
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048  # overridden from 512 (modeling.py:110)
    norm_eps: float = 1e-12


@dataclass(frozen=True)
class DecoderConfig:
    """Caption decoder (reference clip4caption/modules/decoder-base/decoder_config.json
    + args.py:54 override)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_decoder_layers: int = 2       # decoder_config.json says 1; args.py:54 overrides to 2
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_target_embeddings: int = 512
    norm_eps: float = 1e-12


@dataclass(frozen=True)
class JointModelConfig:
    """The joint multitask model trunk + heads (reference modeling.py:18-123)."""

    embed_dim: int = 512              # fused trunk width before the visual encoder
    trunk_dim: int = 768              # visual-encoder output width feeding the heads
    clip_dim: int = 1024              # EVA-CLIP-g joint embedding dim
    asr_dim: int = -1                 # 384 (MiniLM) / 512 (CLIP) / -1 (no ASR)
    max_frames_step_captioning: int = 20
    max_words: int = 48
    visual: VisualEncoderConfig = field(default_factory=VisualEncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)

    @property
    def use_asr(self) -> bool:
        return self.asr_dim > 0


# ---------------------------------------------------------------------------
# Run configuration (CLI parity with reference args.py)
# ---------------------------------------------------------------------------


@dataclass
class HirestConfig:
    # Mode
    train: bool = False
    seed: int = 2222
    comment: str = ""
    device: str = "cuda"                 # "cuda" or "cpu"

    # Data directories
    data_dir: str = ""
    video_feature_dir: str = ""
    # root of per-video extracted-frame directories (raw-frame retrieval;
    # reference inference_video_retrieval.py:221 args.video_dir)
    video_dir: str = ""
    asr_dir: Optional[str] = None
    asr_feature_dir: Optional[str] = None

    # Tasks
    task_moment_retrieval: bool = False
    task_moment_segmentation: bool = False
    task_step_captioning: bool = False
    end_to_end: bool = False

    # Training & optimizer
    train_batch_size: int = 32
    eval_batch_size: int = 32
    clip_grad_norm: float = -1.0
    gradient_accumulation_steps: int = 1
    epochs: int = 10
    optim: str = "adamw"
    lr: float = 1e-5
    fp16: bool = False                 # selects bf16 compute
    # the reference's --weight_decay flag (args.py:34, default 0.0) is
    # parsed but never reaches its optimizer: trainer_base.py:56-59 builds
    # torch AdamW with ITS default 0.01. Default 0.01 here matches what
    # reference training effectively runs; the flag is live (honored).
    weight_decay: float = 0.01
    warmup_steps: float = 0.1

    # Data loading
    n_model_frames: int = -1
    num_workers: int = 4

    # Distributed
    distributed: bool = False

    # Checkpoints
    load: Optional[str] = None
    ckpt_dir: str = "./checkpoints/"

    # clip4caption-side knobs
    num_thread_reader: int = 16
    n_display: int = 16
    max_frames_step_captioning: int = 20
    max_words: int = 48
    visual_num_hidden_layers: int = 2
    decoder_num_hidden_layers: int = 2

    # moment segmentation
    moment_segmentation_difference_threshold: float = 0.50
    moment_segmentation_max_iterations: int = 20

    # step captioning
    num_beams: int = 5

    # video retrieval
    run_name: str = "clip_g_VR_32frames_avgpool"
    video_retrieval_model: str = "clip_g"
    raw_frame: bool = False
    save_feats: bool = False

    # additions of the JAX package (not in the reference CLI)
    frame_buckets: tuple = (64, 128, 256, 512, 1024, 2048)
    compute_dtype: str = "bfloat16"
    mesh_shape: Optional[str] = None   # e.g. "data:8" or "data:4,model:2"
    pretrained_dir: str = "./pretrained_weights"
    use_pallas_attention: bool = False
    trace_dir: Optional[str] = None       # profiler trace output
    metrics_log: Optional[str] = None     # JSONL scalar-metrics sink
    save_every_steps: int = 0             # periodic LAST checkpoint (preemption safety)
    fused_segmentation: bool = False      # run the iterative segmentation loop
                                          # on the device, one fetch at the end

    # -- derived --------------------------------------------------------
    @property
    def tasks(self) -> list[str]:
        tasks = []
        if self.task_moment_retrieval:
            tasks.append("moment_retrieval")
        if self.task_moment_segmentation:
            tasks.append("moment_segmentation")
        if self.task_step_captioning:
            tasks.append("step_captioning")
        return tasks

    @property
    def asr_dim(self) -> int:
        """Infer the ASR embedding width from the feature dir name
        (reference run.py:45-49). Matched on the BASENAME only: an
        unrelated ancestor directory containing 'clip' (e.g.
        /data/clip4caption/asr_feats_minilm) must not silently flip the
        model to 512-dim against 384-dim MiniLM files."""
        if not self.asr_feature_dir:
            return -1
        name = os.path.basename(os.path.normpath(self.asr_feature_dir)).lower()
        if "clip" in name:
            return 512
        if "minilm" in name:
            return 384
        return -1

    def joint_model_config(self) -> JointModelConfig:
        return JointModelConfig(
            asr_dim=self.asr_dim,
            max_frames_step_captioning=self.max_frames_step_captioning,
            max_words=self.max_words,
            visual=VisualEncoderConfig(num_hidden_layers=self.visual_num_hidden_layers),
            decoder=DecoderConfig(num_decoder_layers=self.decoder_num_hidden_layers),
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["frame_buckets"] = list(d["frame_buckets"])
        return json.dumps(d, indent=2)

    @classmethod
    def from_args(cls, argv: Optional[list[str]] = None) -> "HirestConfig":
        parser = get_parser()
        ns = parser.parse_args(argv)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(ns).items() if k in known}
        if kwargs.get("frame_buckets"):
            kwargs["frame_buckets"] = tuple(int(x) for x in kwargs["frame_buckets"].split(","))
        else:
            kwargs.pop("frame_buckets", None)
        return cls(**kwargs)


def get_parser() -> argparse.ArgumentParser:
    """Flag-name parity with reference args.py:3-71, plus the JAX
    package's extensions (the same flags as hirest_tpu.config.get_parser)."""
    parser = argparse.ArgumentParser()

    parser.add_argument("--train", action="store_true")
    parser.add_argument("--seed", type=int, default=2222)
    parser.add_argument("--comment", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default) or 'cpu'")

    # Data directories
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--video_feature_dir", type=str, required=True)
    parser.add_argument("--video_dir", type=str, default="",
                        help="extracted-frames root for --raw_frame")
    parser.add_argument("--asr_dir", type=str, required=False)
    parser.add_argument("--asr_feature_dir", type=str, required=False)

    # Tasks
    parser.add_argument("--task_moment_retrieval", action="store_true")
    parser.add_argument("--task_moment_segmentation", action="store_true")
    parser.add_argument("--task_step_captioning", action="store_true")
    parser.add_argument("--end_to_end", action="store_true")

    # Training & optimizer
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--eval_batch_size", type=int, default=32)
    parser.add_argument("--clip_grad_norm", type=float, default=-1.0)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--optim", type=str, default="adamw")
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--fp16", action="store_true")
    # default matches the reference's EFFECTIVE decay (torch AdamW 0.01;
    # its own flag is dead code) — see HirestConfig.weight_decay
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--warmup_steps", type=float, default=0.1)

    # Data loading
    parser.add_argument("--n_model_frames", type=int, default=-1)
    parser.add_argument("--num_workers", type=int, default=4)

    # Distributed
    parser.add_argument("--distributed", action="store_true")

    # Checkpoints
    parser.add_argument("--load", type=str, default=None)
    parser.add_argument("--ckpt_dir", type=str, default="./checkpoints/")

    # Model - clip4cap
    parser.add_argument("--num_thread_reader", type=int, default=16)
    parser.add_argument("--n_display", type=int, default=16)
    parser.add_argument("--max_frames_step_captioning", type=int, default=20)
    parser.add_argument("--max_words", type=int, default=48)
    parser.add_argument("--visual_num_hidden_layers", type=int, default=2)
    parser.add_argument("--decoder_num_hidden_layers", type=int, default=2)

    # moment segmentation
    parser.add_argument("--moment_segmentation_difference_threshold", type=float, default=0.50)
    parser.add_argument("--moment_segmentation_max_iterations", type=int, default=20)

    # step captioning
    parser.add_argument("--num_beams", type=int, default=5)

    # video retrieval
    parser.add_argument("--run_name", type=str, default="clip_g_VR_32frames_avgpool")
    parser.add_argument("--video_retrieval_model", type=str, default="clip_g")
    parser.add_argument("--raw_frame", action="store_true",
                        help="use raw frames instead of video features")
    parser.add_argument("--save_feats", action="store_true",
                        help="save video features to disk")

    # extensions of the JAX package
    parser.add_argument("--frame_buckets", type=str, default="",
                        help="comma-separated static frame-length buckets")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    parser.add_argument("--mesh_shape", type=str, default=None,
                        help='device mesh, e.g. "data:8" or "data:4,model:2"')
    parser.add_argument("--pretrained_dir", type=str, default="./pretrained_weights")
    parser.add_argument("--use_pallas_attention", action="store_true")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a profiler trace of the first train step")
    parser.add_argument("--metrics_log", type=str, default=None,
                        help="append scalar metrics as JSONL to this path")
    parser.add_argument("--save_every_steps", type=int, default=0,
                        help="save a LAST checkpoint every N steps (0 = per epoch only)")
    parser.add_argument("--fused_segmentation", action="store_true",
                        help="run the segmentation decode loop fully on-device")

    return parser
