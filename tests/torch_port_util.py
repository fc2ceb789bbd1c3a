"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

One place builds the seeded EVA vision and text state dicts, and the joint
model's, that every port test loads into both packages: reference key
names, so the port loads them directly and the JAX package maps them with
`convert_eva_vision`, `convert_eva_text` and `convert_moment_model`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import hirest_tpu.config as jax_config
import hirest_tpu_torch.config as port_config
from hirest_tpu.config import EvaTextConfig as JaxEvaTextConfig
from hirest_tpu.config import EvaVisionConfig as JaxEvaVisionConfig
from hirest_tpu.models.convert import (convert_eva_text, convert_eva_vision,
                                       convert_moment_model)
from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                         random_eva_vision_state_dict,
                                         random_moment_state_dict)

# the tiny configs of tests/test_eva_scan.py: TINY (64 wide, the flax
# tower's unpacked attention) and PACKED (128 wide, the width at which the
# JAX forward takes its v3 Pallas kernel)
TINY = dict(image_size=28, layers=3, width=64, head_width=16, mlp_ratio=4.0,
            patch_size=14, embed_dim=32)
PACKED = dict(image_size=28, layers=3, width=128, head_width=32,
              mlp_ratio=4.0, patch_size=14, embed_dim=32)
# 224 px input (what preprocess_image makes) on a 4x4 patch grid
TINY224 = dict(image_size=224, layers=2, width=128, head_width=32,
               mlp_ratio=4.0, patch_size=56, embed_dim=32)

# random_eva_vision_state_dict draws at 0.02; at these small widths that
# leaves the softmax nearly uniform, so the tests scale the qkv projection
# up to give scores of order one and exercise the attention for real
QKV_GAIN = 4.0


# a small text tower: 2 layers, 4 heads of 16, context 16, vocab 100
TEXT_TINY = dict(context_length=16, vocab_size=100, width=64, heads=4,
                 layers=2, embed_dim=32)


def configs(spec: dict):
    """(JAX config, port config) for one spec."""
    return JaxEvaVisionConfig(**spec), EvaVisionConfig(**spec)


def eva_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded reference-named EVA vision state dict (float32 numpy)."""
    sd = random_eva_vision_state_dict(EvaVisionConfig(**spec), seed=seed)
    for k in sd:
        if k.endswith("attn.qkv.weight"):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd


def jax_params(sd: dict, spec: dict) -> dict:
    return {"params": convert_eva_vision(sd, JaxEvaVisionConfig(**spec))}


def text_configs(spec: dict):
    """(JAX text config, port text config) for one spec."""
    return JaxEvaTextConfig(**spec), EvaTextConfig(**spec)


def text_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded reference-named EVA text state dict (float32 numpy), the qkv
    projection scaled up as the vision one is."""
    sd = random_eva_text_state_dict(EvaTextConfig(**spec), seed=seed)
    for k in sd:
        if k.endswith("attn.in_proj_weight"):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd


def jax_text_params(sd: dict, spec: dict) -> dict:
    return {"params": convert_eva_text(sd, JaxEvaTextConfig(**spec))}


def text_ids(spec: dict, n: int, seed: int = 0) -> np.ndarray:
    """Token ids [n, context] as a tokenizer gives them: tokens below the
    EOT id (the vocabulary's last), EOT at varied positions, zeros after."""
    ctx, eot = spec["context_length"], spec["vocab_size"] - 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, eot, size=(n, ctx))
    ends = rng.integers(1, ctx, size=n)
    ends[0] = ctx - 1
    for row, end in zip(ids, ends):
        row[end] = eot
        row[end + 1:] = 0
    return ids.astype(np.int32)


def images(spec: dict, n: int, seed: int = 0) -> np.ndarray:
    """Normalised-scale NHWC float32 images."""
    s = spec["image_size"]
    return np.random.default_rng(seed).normal(
        size=(n, s, s, 3)).astype(np.float32)


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def assert_codes_close(got, want, min_equal: float) -> None:
    """int8 codes within one of each other, and equal on a share of at
    least min_equal of them: an f32 rounding that differs lands a value on
    the other side of a code boundary."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()


# joint-model configs: the engine's of tests/test_serve.py:38-44 (a
# 40-token vocabulary, below the default BOS/EOS ids 101/102), the same
# with the ASR branch (asr_dim 384, MiniLM), and the 2-layer decoder of
# tests/test_cached_decode.py:15-17 under a 16-wide trunk
SERVE_JOINT = dict(
    embed_dim=32,
    visual=dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=64),
    decoder=dict(vocab_size=40, hidden_size=32, num_decoder_layers=1,
                 num_attention_heads=4, intermediate_size=64,
                 max_target_embeddings=32))
ASR_JOINT = dict(SERVE_JOINT, asr_dim=384)
CACHED_DECODER = dict(vocab_size=40, hidden_size=16, num_decoder_layers=2,
                      num_attention_heads=4, intermediate_size=32,
                      max_target_embeddings=32)
DECODE_JOINT = dict(
    embed_dim=16,
    visual=dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=32),
    decoder=CACHED_DECODER)

# at these widths the 0.02 draw leaves every softmax nearly uniform: the
# tests scale the query and key projections up (scores of order one) and
# the task heads (peaked frame scores, so segmentation finds segments)
HEAD_GAIN = 30.0


def _joint_config(module, spec: dict):
    spec = dict(spec)
    visual = module.VisualEncoderConfig(**spec.pop("visual", {}))
    decoder = module.DecoderConfig(**spec.pop("decoder", {}))
    return module.JointModelConfig(visual=visual, decoder=decoder, **spec)


def joint_configs(spec: dict):
    """(JAX JointModelConfig, port JointModelConfig) for one spec."""
    return _joint_config(jax_config, spec), _joint_config(port_config, spec)


def joint_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded reference-format joint state dict (float32 numpy)."""
    sd = random_moment_state_dict(joint_configs(spec)[1], seed=seed)
    for k in sd:
        if k.endswith(("query.weight", "key.weight")):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
        elif k.endswith("_predictor.0.weight"):
            sd[k] = sd[k] * np.float32(HEAD_GAIN)
    return sd


def jax_joint_params(sd: dict, spec: dict) -> dict:
    return {"params": convert_moment_model(sd, joint_configs(spec)[0])}


def hirest_configs(**kw):
    """(JAX HirestConfig, port HirestConfig) with the same fields; the
    port's on the CPU."""
    jax_cfg = jax_config.HirestConfig(**kw)
    fields = dataclasses.asdict(jax_cfg)
    fields["device"] = "cpu"
    return jax_cfg, port_config.HirestConfig(**fields)


# a 40-entry WordPiece vocabulary (the SERVE_JOINT decoder's size):
# [PAD] [UNK] [CLS] [SEP] [MASK], the words of the synthetic headings
TINY_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "add", "salt",
               "and", "water", "mix", "##ing", "##ed", "pan", "##cake", "oat",
               "##meal", ",", "."] + [f"w{i}" for i in range(22)])
HEADINGS = ("add salt", "mix water and oatmeal", "pancake mix", "add water",
            "mixed salt , water .", "w1 w2 w3")


def write_split(root, n_videos: int = 4, prompts=("make pancakes",
                                                  "mix oatmeal"),
                seed: int = 0) -> tuple:
    """A synthetic HiREST split in the reference JSON schema under root:
    `all_data_{train,val,test}.json` (n_videos videos a prompt a split,
    3-4 steps each with headings of TINY_VOCAB's words), seeded random
    [round(v_duration), 1024] features in `feats/` (the extractor's rows),
    and `pretrained/vocab.txt`.
    Returns (the data dir, the feature dir, the pretrained dir)."""
    import json
    from pathlib import Path

    root = Path(root)
    data, feats, pre = root / "splits", root / "feats", root / "pretrained"
    for d in (data, feats, pre):
        d.mkdir(parents=True, exist_ok=True)
    (pre / "vocab.txt").write_text("\n".join(TINY_VOCAB) + "\n")
    rng = np.random.default_rng(seed)
    for split in ("train", "val", "test"):
        anns = {}
        for p, prompt in enumerate(prompts):
            videos = {}
            for v in range(n_videos):
                name = f"{split}_{p}_{v}.mp4"
                duration = float(rng.integers(24, 60)) + 0.3
                np.save(feats / f"{name}.npy", rng.normal(size=(
                    round(duration), 1024)).astype(np.float32))
                start = int(rng.integers(1, 6))
                end = int(duration) - int(rng.integers(1, 6))
                cuts = np.sort(rng.choice(np.arange(start + 2, end - 1),
                                          size=int(rng.integers(2, 4)),
                                          replace=False))
                edges = [start, *cuts.tolist(), end]
                videos[name] = {
                    "relevant": True, "clip": True, "v_duration": duration,
                    "bounds": [start, end],
                    "steps": [{"index": i,
                               "heading": HEADINGS[int(rng.integers(
                                   len(HEADINGS)))],
                               "absolute_bounds": [edges[i], edges[i + 1]]}
                              for i in range(len(edges) - 1)]}
            anns[prompt] = videos
        (data / f"all_data_{split}.json").write_text(json.dumps(anns))
    return data, feats, pre


# Whisper: the tiny config of tests/test_whisper.py:24 (d=64, 2 + 2 layers,
# 4 heads, a 200-token vocabulary), and the decode tests' (d=32, 1 + 1
# layers, the real .en vocabulary of 51864 so the special tokens exist)
WHISPER_TINY = dict(num_mel_bins=80, d_model=64, encoder_layers=2,
                    decoder_layers=2, heads=4, ffn_dim=128,
                    max_source_positions=100, max_target_positions=50,
                    vocab_size=200)
WHISPER_DECODE = dict(d_model=32, encoder_layers=1, decoder_layers=1,
                      heads=2, ffn_dim=64)


def whisper_state_dict(spec: dict, seed: int = 0) -> dict:
    """Seeded HF-named Whisper state dict (float32 numpy), the q and k
    projections scaled up (scores of order one)."""
    from hirest_tpu_torch.models.whisper import WhisperConfig
    from hirest_tpu_torch.utils.init import random_whisper_state_dict

    sd = random_whisper_state_dict(WhisperConfig(**spec), seed=seed)
    for k in sd:
        if k.endswith(("q_proj.weight", "k_proj.weight")):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd


def write_byte_vocab(root, n_tokens: int = 50257) -> tuple:
    """A byte-level GPT-2 BPE pair under root (`vocab.json`, `merges.txt`)
    with ids 0 .. n_tokens - 1: the 256 byte symbols, then merged pairs of
    them in a fixed order, `<|endoftext|>` last (id 50256 at the default
    size), so every text id a Whisper decode can emit decodes to bytes.
    Returns (vocab path, merges path)."""
    import json
    from pathlib import Path

    from hirest_tpu_torch.tokenizers.gpt2_bpe import bytes_to_unicode

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    sym = [bytes_to_unicode()[b] for b in range(256)]
    # printable symbols first, so the earliest merges are letter pairs
    order = sorted(range(256), key=lambda b: (not chr(b).isalnum(), b))
    pairs = [(sym[a], sym[b]) for a in order for b in order][
        : n_tokens - 257]
    tokens = sym + [a + b for a, b in pairs] + ["<|endoftext|>"]
    vocab, merges = root / "vocab.json", root / "merges.txt"
    vocab.write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    merges.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}"
                                                     for a, b in pairs))
    return str(vocab), str(merges)


# OpenAI CLIP towers at a small size: text 2 x 128 (2 heads of 64, as
# build_clip_from_state_dict sniffs them), vision 2 x 128 on a 4 x 4 grid
CLIP_TEXT_TINY = dict(context_length=16, vocab_size=100, width=128, heads=2,
                      layers=2, embed_dim=32)
CLIP_VISION_TINY = dict(image_size=64, layers=2, width=128, heads=2,
                        patch_size=16, embed_dim=32)


def clip_state_dict(text_spec=None, vision_spec=None, seed: int = 0) -> dict:
    """Seeded OpenAI-CLIP-named state dict (float32 numpy): ViT-B/32's
    shape by default, else the given specs; the qkv projections scaled up
    as the EVA ones are."""
    from hirest_tpu_torch.config import EvaTextConfig as PortTextConfig
    from hirest_tpu_torch.models.openai_clip import ClipVisionConfig
    from hirest_tpu_torch.utils.init import random_clip_state_dict

    sd = random_clip_state_dict(
        PortTextConfig(**text_spec) if text_spec else None,
        ClipVisionConfig(**vision_spec) if vision_spec else None, seed=seed)
    for k in sd:
        if k.endswith("attn.in_proj_weight"):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    return sd
