"""The training path of the PyTorch port against the JAX package, on the
CPU in f32: losses, both optimizers, the multitask schedule, the
formatters, one gradient per task, the trainer on a synthetic split
(train, predict/evaluate, resume, dropout), the end-to-end pipeline, the
run CLI, the contrastive losses and caption pretraining.

Inputs are seeded numpy arrays given to both packages; the models share
the JAX trainer's weights (moment_model_from_jax). A JAX trainer's dropout
is turned off by setting its `train_model` to its deterministic `model`;
the port's by `Trainer.dropout = False`.

Tolerances (each test states its own where it differs):
- losses: 1e-6 relative; gradients: 1e-5 of each tensor's largest
  magnitude (two frameworks' f32 reductions in different orders);
- optimizers over 6 steps: 1e-6 of each tensor's largest magnitude;
- training runs: per-step losses 1e-5 relative; final parameters within
  1e-3 of how far training moved each tensor (Adam divides by sqrt(v), so
  every update carries its gradient's relative f32 noise, unscaled); a
  tensor whose gradient is zero in exact arithmetic gets Adam steps of
  rounding noise (up to lr each), so it is held to have moved no more
  than 2 lr a step on either side;
- schedules, formatted JSON, predictions and checkpoint round trips:
  equal.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hirest_tpu.train.contrastive as jax_contrastive
import hirest_tpu.train.losses as jax_losses
from hirest_tpu.data.multitask import MultitaskSchedule as JaxSchedule
from hirest_tpu.infer.pipeline import run_end_to_end as jax_run_end_to_end
from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
from hirest_tpu.train import formatting as jax_formatting
from hirest_tpu.train.optim import bert_adam as jax_bert_adam
from hirest_tpu.train.optim import make_optimizer as jax_make_optimizer
from hirest_tpu.train.pretrain import \
    CaptionGenerator as JaxCaptionGenerator
from hirest_tpu.train.pretrain import \
    build_pretrain_examples as jax_build_pretrain_examples
from hirest_tpu.train.pretrain import \
    pretrain_caption_generator as jax_pretrain
from hirest_tpu.train.trainer import Trainer as JaxTrainer
from hirest_tpu_torch.data.features import FeatureStore
from hirest_tpu_torch.data.multitask import MultitaskSchedule
from hirest_tpu_torch.infer.pipeline import run_end_to_end
from hirest_tpu_torch.models.caption import Dropout
from hirest_tpu_torch.models.convert import (caption_decoder_from_jax,
                                             moment_model_from_jax,
                                             visual_encoder_from_jax)
from hirest_tpu_torch.models.joint import MomentModel
from hirest_tpu_torch.tokenizers import WordPieceTokenizer
from hirest_tpu_torch.train import contrastive, formatting, losses
from hirest_tpu_torch.train import pretrain as pretrain_module
from hirest_tpu_torch.train.optim import apply_updates, bert_adam, \
    make_optimizer
from hirest_tpu_torch.train.pretrain import (CaptionGenerator,
                                             build_pretrain_examples,
                                             init_moment_model_from_pretrain,
                                             pretrain_caption_generator)
from hirest_tpu_torch.train.trainer import Trainer

from torch_port_util import (SERVE_JOINT, hirest_configs, joint_configs,
                             write_split)

TASKS = ("moment_retrieval", "moment_segmentation", "step_captioning")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- losses ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.default_rng(1)
    b, t, length, vocab = 4, 12, 6, 30
    start, end, seg = (rng.normal(size=(b, t)).astype(np.float32) * 3
                       for _ in range(3))
    st, et = rng.integers(0, t, b), rng.integers(0, t, b)
    mm = (rng.random((b, t)) > 0.3).astype(np.int32)
    mm[np.arange(b), st] = 1
    logits = rng.normal(size=(b, length, vocab)).astype(np.float32) * 2
    out_ids = rng.integers(0, vocab, (b, length))
    out_ids[:, -2:] = 0  # PAD positions count
    bm = np.array([1, 1, 1, 0], np.int32) if masked else None

    def jm(a):
        return None if a is None else jnp.asarray(a)

    def pm(a):
        return None if a is None else _t(a)

    pairs = [
        (losses.moment_retrieval_loss(_t(start), _t(end), _t(st), _t(et),
                                      _t(mm), pm(bm)),
         jax_losses.moment_retrieval_loss(jm(start), jm(end), jm(st), jm(et),
                                          jm(mm), jm(bm))),
        (losses.moment_segmentation_loss(_t(seg), _t(st), _t(mm), pm(bm)),
         jax_losses.moment_segmentation_loss(jm(seg), jm(st), jm(mm),
                                             jm(bm))),
        (losses.step_captioning_loss(_t(logits), _t(out_ids), pm(bm)),
         jax_losses.step_captioning_loss(jm(logits), jm(out_ids), jm(bm)))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        _close(float(got), float(want), 1e-6)


def test_segmentation_loss_masks_with_finite_min():
    """Out-of-moment logits are -float32.max, not -inf: a row whose target
    lies outside its moment gives a large finite loss, as in JAX."""
    seg = torch.zeros(1, 4)
    mm = torch.tensor([[1, 1, 0, 0]])
    got = losses.moment_segmentation_loss(seg, torch.tensor([3]), mm)
    want = jax_losses.moment_segmentation_loss(
        jnp.zeros((1, 4)), jnp.array([3]), jnp.array([[1, 1, 0, 0]]))
    assert np.isfinite(float(got)) and float(got) == float(want)


# -- optimizers -----------------------------------------------------------

SHAPES = {"a.weight": (5, 3), "a.bias": (5,), "b.LayerNorm.weight": (4,),
          "emb": (7, 2)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}


def _grads(n, seed=1):
    """n steps of gradients, scaled per step so that global norms fall on
    both sides of 1 (both clipping branches), with one exact zero."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {k: (rng.normal(size=s) * [0.05, 3.0][i % 2]).astype(np.float32)
             for k, s in SHAPES.items()}
        g["emb"][0] = 0.0
        out.append(g)
    return out


def _run_optax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()},
                                state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_port(tx, params, grads):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: _t(v) for k, v in g.items()}, state,
                                   p)
        apply_updates(p, updates)
    return {k: v.numpy() for k, v in p.items()}, state


@pytest.mark.parametrize("clip", [-1.0, 1.0])
@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("warmup", [0.3, 2])
def test_make_optimizer_matches_optax(clip, accum, warmup):
    """6 updates (18 mini-steps with accumulation 3) of make_optimizer
    against the JAX chain, lr 0.1 so the steps are large."""
    n = 6 * accum
    total = n // accum
    params, grads = _params(), _grads(n)
    if clip > 0:  # both branches of the clip are reached
        norms = [np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in g.values())) for g in grads]
        assert min(norms) < clip < max(norms)
    want = _run_optax(jax_make_optimizer(0.1, warmup, total, clip, 0.01,
                                         accum), params, grads)
    got, state = _run_port(make_optimizer(0.1, warmup, total, clip, 0.01,
                                          accum), params, grads)
    for k in SHAPES:
        _close(got[k], want[k], 1e-6)
        assert not np.array_equal(got[k], params[k])
    inner = state["inner"] if accum > 1 else state
    assert int(inner["count"]) == total


def test_first_update_has_zero_lr_under_warmup():
    """optax reads the schedule at the count of updates already applied:
    with warmup the first update moves nothing."""
    params, grads = _params(), _grads(1)
    got, _ = _run_port(make_optimizer(0.1, 2, 6), params, grads)
    for k in SHAPES:
        assert np.array_equal(got[k], params[k])


def test_accumulation_leaves_params_between_updates():
    params, grads = _params(), _grads(2)
    got, state = _run_port(make_optimizer(0.1, 0, 6, accum_steps=3),
                           params, grads)
    for k in SHAPES:
        assert np.array_equal(got[k], params[k])
    assert state["mini_step"] == 2 and state["gradient_step"] == 0
    _close(state["acc"]["a.weight"].numpy(),
           (grads[0]["a.weight"] + grads[1]["a.weight"]) / 2, 1e-6)


@pytest.mark.parametrize("schedule", ["warmup_linear", "warmup_cosine",
                                      "warmup_constant"])
def test_bert_adam_matches_jax(schedule):
    params, grads = _params(), _grads(6)
    mask = {k: not (k.endswith("bias") or "LayerNorm" in k) for k in SHAPES}
    want = _run_optax(jax_bert_adam(0.05, warmup=0.3, t_total=6,
                                    schedule=schedule, decay_mask=mask),
                      params, grads)
    got, state = _run_port(bert_adam(0.05, warmup=0.3, t_total=6,
                                     schedule=schedule, decay_mask=mask),
                           params, grads)
    for k in SHAPES:
        _close(got[k], want[k], 1e-6)
    assert int(state["step"]) == 6


def test_bert_adam_without_schedule_matches_jax():
    params, grads = _params(2), _grads(4, seed=3)
    want = _run_optax(jax_bert_adam(0.01, max_grad_norm=-1), params, grads)
    got, _ = _run_port(bert_adam(0.01, max_grad_norm=-1), params, grads)
    for k in SHAPES:
        _close(got[k], want[k], 1e-6)


# -- the multitask schedule and the formatters -----------------------------


class _Batcher:
    """n batches of one task, tagged with their index and epoch."""

    def __init__(self, task, n):
        self.task, self.n, self.epoch = task, n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield {"tasks": [self.task], "i": i, "epoch": self.epoch}


@pytest.mark.parametrize("sampling,n_batches", [("roundrobin", None),
                                                ("balanced", None),
                                                ("balanced", 5)])
def test_multitask_schedule_matches_jax(sampling, n_batches):
    sizes = {"moment_retrieval": 3, "moment_segmentation": 7,
             "step_captioning": 5}

    def order(cls):
        sched = cls({t: _Batcher(t, n) for t, n in sizes.items()},
                    shuffle=True, sampling=sampling, n_batches=n_batches)
        out = []
        for epoch in range(3):
            sched.set_epoch(epoch)
            out.append((len(sched), [(b["tasks"][0], b["i"], b["epoch"])
                                     for b in sched]))
        return out

    assert order(MultitaskSchedule) == order(JaxSchedule)


def test_formatters_match_jax_bytes():
    rng = np.random.default_rng(4)
    fnames = [f"v{i}.mp4" for i in range(4)]
    durations = [31, 45, 45, 60]
    prompts = ["a", "b", "a", "c"]
    mr = rng.integers(0, 30, (4, 2)).tolist()
    ms = [sorted(rng.integers(0, 30, 4).tolist()) for _ in range(4)]
    ms[1] = [3, 80]  # out of the video: the formatter's except branch
    sc = ["add salt", "mix", "", "w1 w2"]
    for name, args, kw in (
            ("format_moment_retrieval", (prompts, fnames, durations, mr, -1),
             dict(targets=mr, loss=0.25)),
            ("format_moment_retrieval", (prompts, fnames, durations, mr, 30),
             {}),
            ("format_moment_segmentation", (fnames, durations, ms, -1),
             dict(targets=ms, loss=1.5)),
            ("format_step_captioning", (fnames, durations, sc),
             dict(targets=sc, loss=2.0))):
        got = getattr(formatting, name)(*args, **kw)
        want = getattr(jax_formatting, name)(*args, **kw)
        assert json.dumps(got, indent=4) == json.dumps(want, indent=4)


# -- the trainer on a synthetic split ---------------------------------------


def _text_fn(ids):
    """A deterministic text feature of the token ids, shared by both
    packages (the EVA text tower has its own parity tests)."""
    w = np.random.default_rng(7).normal(size=(77, 1024)).astype(np.float32)
    return (np.asarray(ids, np.float32) / 49407.0) @ w


def _pair(root, **overrides):
    """(JAX trainer, port trainer) on one synthetic split, the port's model
    carrying the JAX trainer's weights; dropout off on both."""
    data, feats, pre = write_split(root)
    kw = dict(data_dir=str(data), video_feature_dir=str(feats),
              pretrained_dir=str(pre), ckpt_dir=str(root / "ckpt"),
              task_moment_retrieval=True, task_moment_segmentation=True,
              task_step_captioning=True, train_batch_size=3,
              eval_batch_size=2, num_beams=2, max_words=8, epochs=1,
              moment_segmentation_max_iterations=4, frame_buckets=(64,),
              num_workers=0, lr=1e-3, warmup_steps=0.2, clip_grad_norm=1.0)
    kw.update(overrides)
    jax_cfg, cfg = hirest_configs(**kw)
    jax_model_cfg, model_cfg = joint_configs(SERVE_JOINT)
    vocab = str(pre / "vocab.txt")
    jt = JaxTrainer(jax_cfg, text_encoder_fn=_text_fn,
                    wordpiece_tokenizer=JaxWordPiece(vocab), verbose=False,
                    model_config=jax_model_cfg)
    jt.train_model = jt.model
    model = MomentModel(model_cfg, dtype=torch.bfloat16 if kw.get("fp16")
                        else torch.float32)
    model.load_state_dict(moment_model_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.params)))
    trainer = Trainer(cfg, text_encoder_fn=_text_fn,
                      wordpiece_tokenizer=WordPieceTokenizer(vocab),
                      model=model, verbose=False, model_config=model_cfg)
    trainer.dropout = False
    return jt, trainer


def _first_batch(t, task, split="train"):
    return next(iter(t.loaders[split][task]))


def _port_params(jax_params):
    return moment_model_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jax_params))


def _zero_in_exact_arithmetic(task: str, name: str, layers: int) -> bool:
    """Parameters whose gradient is exactly zero in exact arithmetic: every
    key bias (a softmax is unchanged when one constant is added to all of a
    query's scores) and, for segmentation, whatever adds one vector to every
    frame ahead of the frame softmax (the head's bias, the last encoder
    layer's output LayerNorm bias). Both frameworks return f32 rounding
    noise there, which no relative bar can hold."""
    if name.endswith("key.bias"):
        return True
    return task == "moment_segmentation" and name in (
        "segment_predictor.0.bias",
        f"clip4cap_model.visual.encoder.layer.{layers - 1}.output."
        "LayerNorm.bias")


# bf16 training (config.fp16) bar: losses within 2e-3 relative. A one-epoch
# train() with fp16=True against the JAX trainer on this split saw first
# steps within 3.1e-5 to 4.6e-4 relative and its worst of 22 steps at
# 2.7e-3 (ROADMAP.md §1, `--fp16` training); one step a task is held here.
BF16_LOSS_TOL = 2e-3


@pytest.mark.parametrize("task,fp16", [pytest.param(t, False, id=t)
                                       for t in TASKS]
                         + [pytest.param(t, True, id=f"{t}-fp16")
                            for t in TASKS])
def test_one_gradient_per_task_matches_jax(tmp_path, task, fp16):
    """Every gradient within 1e-5 of its tensor's largest magnitude; those
    that are zero in exact arithmetic within 1e-6 of the model's largest
    gradient on both sides. With fp16 (both trainers compute in bf16 on
    f32 parameters) one train_step of each trainer on the same weights and
    batch: the losses within BF16_LOSS_TOL relative (bf16 rounds at other
    places in the two frameworks), the updated parameters finite."""
    if fp16:
        _bf16_train_step_matches_jax(tmp_path, task)
        return
    jt, trainer = _pair(tmp_path)
    jarrs = jt._prepare(_first_batch(jt, task), task)
    arrs = trainer._prepare(_first_batch(trainer, task), task)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_for_task(p, task, jarrs)))(jt.params)
    loss, grads = trainer.loss_and_grads(task, arrs)
    _close(float(loss), float(want_loss), 1e-6)
    want = {k: v.numpy() for k, v in _port_params(want).items()}
    assert set(grads) == set(want)
    top = max(np.abs(v).max() for v in want.values())
    layers = SERVE_JOINT["visual"]["num_hidden_layers"]
    reached = 0
    for k, g in grads.items():
        if _zero_in_exact_arithmetic(task, k, layers):
            assert max(np.abs(g.numpy()).max(),
                       np.abs(want[k]).max()) <= 1e-6 * top, k
            continue
        _close(g.numpy(), want[k], 1e-5)
        reached += bool(np.abs(want[k]).max() > 0)
    assert reached > len(want) // 3


def _bf16_train_step_matches_jax(tmp_path, task):
    jt, trainer = _pair(tmp_path, fp16=True)
    assert trainer.dtype == torch.bfloat16
    assert trainer.model.dtype == torch.bfloat16
    assert jt.model.dtype == jnp.bfloat16
    jarrs = jt._prepare(_first_batch(jt, task), task)
    arrs = trainer._prepare(_first_batch(trainer, task), task)
    for t in (jt, trainer):
        t.setup_optimizer(4)
    jt.params, jt.opt_state, want = jt._get_train_step(task)(
        jt.params, jt.opt_state, jarrs, jnp.asarray(0, jnp.uint32))
    loss = trainer.train_step(task, arrs)
    assert np.isfinite(float(want))
    _close(float(loss), float(want), BF16_LOSS_TOL)
    for k, v in trainer.model.state_dict().items():
        assert torch.isfinite(v.float()).all(), k


def test_train_one_epoch_matches_jax(tmp_path):
    """Trainer.train() for one epoch on both: the same batches in the same
    order, per-step losses within 1e-5 relative, the final (BEST)
    parameters within 1e-3 of how far training moved each tensor (the
    parameters whose gradient is zero in exact arithmetic moved no more
    than 2 lr a step on either), and the test predictions' JSONs equal."""
    jt, trainer = _pair(tmp_path)
    init = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}
    jl, pl = [], []
    get_step = jt._get_train_step

    def recording(task):
        fn = get_step(task)

        def step(*a):
            out = fn(*a)
            jl.append((task, float(out[2])))
            return out
        return step

    jt._get_train_step = recording
    port_step = trainer.train_step
    trainer.train_step = lambda task, arrs: pl.append(
        (task, float(port_step(task, arrs)))) or torch.tensor(pl[-1][1])
    want_results = jt.train()
    results = trainer.train()
    assert [t for t, _ in pl] == [t for t, _ in jl] and len(pl) >= 8
    assert set(t for t, _ in pl) == set(TASKS)
    for (_, a), (_, b) in zip(pl, jl):
        _close(a, b, 1e-5)
    state = trainer.model.state_dict()
    lr = trainer.config.lr
    layers = SERVE_JOINT["visual"]["num_hidden_layers"]
    for k, v in _port_params(jt.params).items():
        got, want = state[k].numpy(), v.numpy()
        if _zero_in_exact_arithmetic("moment_segmentation", k, layers) \
                and not k.endswith("LayerNorm.bias"):
            for p in (got, want):
                assert np.abs(p - init[k]).max() <= 2 * lr * len(pl), k
            continue
        moved = np.abs(want - init[k]).max()
        assert moved > 0, k
        assert np.abs(got - want).max() <= 1e-3 * moved, k
    assert trainer.step == jt.step == len(pl)
    for task in TASKS:
        assert (json.dumps(results[task])
                == json.dumps(want_results[task])), task
        on_disk = json.loads((tmp_path / "ckpt" /
                              f"test_{task}_BEST.json").read_text())
        assert on_disk == json.loads(json.dumps(results[task]))
    for name in ("BEST.pt", "LAST.pt"):
        assert (tmp_path / "ckpt" / name).exists()


@pytest.mark.parametrize("split,has_target", [("test", False),
                                              ("val", True)])
def test_predict_and_evaluate_match_jax(tmp_path, split, has_target):
    """The split predictions of shared weights: equal JSON, the loss
    within 1e-6 relative."""
    jt, trainer = _pair(tmp_path)
    for task in TASKS:
        want = jt.evaluate(jt.loaders[split][task], task,
                           has_target=has_target)
        got = trainer.evaluate(trainer.loaders[split][task], task,
                               has_target=has_target)
        if "loss" in want:
            _close(got.pop("loss"), want.pop("loss"), 1e-6)
        assert json.dumps(got) == json.dumps(want), task


def test_resume_matches_unbroken_run(tmp_path):
    """A fresh trainer loaded from a mid-run LAST restores step, epoch,
    the model and the optimizer state (moments, count, accumulator)
    exactly, and its next step equals the unbroken run's."""
    _, a = _pair(tmp_path, gradient_accumulation_steps=2)
    a.setup_optimizer(len(MultitaskSchedule(a.loaders["train"])))
    batches = [(t, a._prepare(_first_batch(a, t), t)) for t in TASKS]
    for task, arrs in batches:
        a.train_step(task, arrs)
    a.epoch = 1
    a.save("LAST")
    saved = torch.load(tmp_path / "ckpt" / "LAST.pt", weights_only=True)

    _, b = _pair(tmp_path, gradient_accumulation_steps=2)
    b.load(str(tmp_path / "ckpt" / "LAST"))
    assert (b.step, b.start_epoch) == (3, 1)

    def same(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y

    same(b.opt_state, a.opt_state)
    same(b.opt_state, saved["opt_state"])
    assert b.opt_state["mini_step"] == 1
    assert int(b.opt_state["inner"]["count"]) == 1
    same(b.model.state_dict(), a.model.state_dict())
    for t in (a, b):
        t.train_step(*batches[0])
    same(b.model.state_dict(), a.model.state_dict())
    same(b.opt_state, a.opt_state)


def test_load_refuses_a_mismatched_optimizer_state(tmp_path):
    _, a = _pair(tmp_path, gradient_accumulation_steps=2)
    a.setup_optimizer(4)
    a.save("LAST")
    _, b = _pair(tmp_path)
    with pytest.raises(ValueError, match="does not match"):
        b.load(str(tmp_path / "ckpt" / "LAST.pt"))


def test_dropout_live_in_training_only(tmp_path):
    """With dropout on, a training step's loss differs from the eval loss
    and depends on the step (its masks come from (seed, step)); the same
    step repeats exactly; with dropout off it is the eval loss; eval()
    mode, the predictions included, stays deterministic."""
    _, t = _pair(tmp_path)
    task = "step_captioning"
    arrs = t._prepare(_first_batch(t, task), task)
    eval_loss = t._eval_loss(task, arrs)
    t.dropout = True
    l0, g0 = t.loss_and_grads(task, arrs)
    l0b, g0b = t.loss_and_grads(task, arrs)
    t.step = 1
    l1, _ = t.loss_and_grads(task, arrs)
    assert float(l0) != eval_loss and float(l1) != float(l0)
    assert float(l0b) == float(l0)
    assert all(torch.equal(g0[k], g0b[k]) for k in g0)
    assert not t.model.training
    assert all(not m.training for m in t.model.modules()
               if isinstance(m, Dropout))
    t.dropout = False
    assert float(t.loss_and_grads(task, arrs)[0]) == eval_loss
    assert t._eval_loss(task, arrs) == eval_loss
    assert (t._predict_step_captioning(arrs)
            == t._predict_step_captioning(arrs))


def test_train_refuses_without_tokenizer_or_val(tmp_path):
    _, t = _pair(tmp_path)
    t.tokenizer = None
    with pytest.raises(ValueError, match="WordPiece"):
        t.train()
    _, t = _pair(tmp_path)
    del t.loaders["val"]
    with pytest.raises(ValueError, match="validation split"):
        t.train()


def test_mesh_shape_needs_divisible_batches(tmp_path):
    """JAX's check, made before the ranks are needed: a batch size that the
    mesh's 'data' axis does not divide is a ValueError."""
    for sizes in (dict(train_batch_size=3), dict(eval_batch_size=5)):
        _, cfg = hirest_configs(mesh_shape="data:2,model:1", pretrained_dir=str(
            tmp_path / "none"), **sizes)
        with pytest.raises(ValueError, match="divisible by the mesh 'data'"):
            Trainer(cfg, text_encoder_fn=_text_fn, verbose=False)


def test_run_end_to_end_matches_jax(tmp_path):
    jt, trainer = _pair(tmp_path)
    want = jax_run_end_to_end(jt)
    want_files = {p.name: p.read_text() for p in (tmp_path / "ckpt").glob(
        "*.json")}
    for p in (tmp_path / "ckpt").glob("*.json"):
        p.unlink()
    got = run_end_to_end(trainer)
    assert got == want
    got_files = {p.name: p.read_text() for p in (tmp_path / "ckpt").glob(
        "*.json")}
    assert got_files == want_files and len(got_files) == 4


def test_run_cli_trains_evaluates_and_resumes_on_cpu(tmp_path, capsys):
    """`python -m hirest_tpu_torch.run --train --device cpu` (in process)
    writes BEST.pt, LAST.pt and the test JSONs; evaluation with --load of
    BEST.pt writes the same test JSONs."""
    from hirest_tpu_torch.run import main

    data, feats, pre = write_split(tmp_path, n_videos=2)
    ckpt = tmp_path / "ckpt"
    base = ["--data_dir", str(data), "--video_feature_dir", str(feats),
            "--pretrained_dir", str(pre), "--ckpt_dir", str(ckpt),
            "--task_moment_retrieval", "--task_moment_segmentation",
            "--task_step_captioning", "--epochs", "1", "--num_beams", "2",
            "--max_words", "8", "--train_batch_size", "4",
            "--eval_batch_size", "4", "--visual_num_hidden_layers", "1",
            "--decoder_num_hidden_layers", "1", "--num_workers", "0",
            "--moment_segmentation_max_iterations", "3", "--device", "cpu"]
    main(base + ["--train"])
    assert (ckpt / "BEST.pt").exists() and (ckpt / "LAST.pt").exists()
    trained = {t: json.loads((ckpt / f"test_{t}_BEST.json").read_text())
               for t in TASKS}
    for t in TASKS:
        (ckpt / f"test_{t}_BEST.json").unlink()
    main(base + ["--load", str(ckpt / "BEST.pt")])
    for t in TASKS:
        assert json.loads((ckpt / f"test_{t}_BEST.json").read_text()) \
            == trained[t]
    vids = trained["moment_segmentation"]
    assert vids and all(v["bounds"] for v in vids.values())
    assert all(isinstance(c["sentence"], str)
               for v in trained["step_captioning"].values()
               for c in v["captions"])


# -- contrastive losses and caption pretraining ------------------------------


@pytest.mark.parametrize("n_pair", [1, 2])
def test_contrastive_losses_match_jax(n_pair):
    s = np.random.default_rng(n_pair).normal(size=(6, 6)).astype(np.float32)
    for name, kw in (("cross_en", {}), ("milnce", dict(n_pair=n_pair)),
                     ("max_margin_ranking", dict(margin=0.2))):
        if name != "milnce" and n_pair > 1:
            continue
        got = getattr(contrastive, name)(_t(s), **kw)
        want = getattr(jax_contrastive, name)(jnp.asarray(s), **kw)
        _close(float(got), float(want), 1e-6)


def _generator_state_dict(params):
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    return {"normalize_video.visual_norm2d.weight": p["normalize_video"][
                "scale"],
            "normalize_video.visual_norm2d.bias": p["normalize_video"][
                "bias"],
            **{f"visual.{k}": v.numpy() for k, v in
               visual_encoder_from_jax(p["encoder"]).items()},
            **{f"decoder.{k}": v.numpy() for k, v in
               caption_decoder_from_jax(p["decoder"]).items()}}


def test_pretrain_matches_jax(tmp_path, monkeypatch):
    """build_pretrain_examples equal to JAX's, and two epochs of
    pretrain_caption_generator from the JAX loop's initial weights: each
    step's loss, and so each epoch's mean, within 1e-5 relative of the JAX
    loop's; the trained parameters within 1e-3 of how far training moved
    each tensor, the key biases (zero gradient in exact arithmetic) moved
    no more than 2 lr a step, as in test_train_one_epoch_matches_jax."""
    from hirest_tpu.data.features import FeatureStore as JaxFeatureStore

    data, feats, pre = write_split(tmp_path, n_videos=3)
    anns = json.loads((data / "all_data_train.json").read_text())
    vocab = str(pre / "vocab.txt")
    want_ex = jax_build_pretrain_examples(anns, JaxFeatureStore(str(feats)),
                                          JaxWordPiece(vocab), 8, 6)
    ex = build_pretrain_examples(anns, FeatureStore(str(feats)),
                                 WordPieceTokenizer(vocab), 8, 6)
    assert len(ex) == len(want_ex) >= 8
    for e, w in zip(ex, want_ex):
        assert e.keys() == w.keys() and e["caption"] == w["caption"]
        for k in ("vis_feats", "input_caption_ids", "output_caption_ids",
                  "decoder_mask"):
            np.testing.assert_array_equal(e[k], w[k])

    jax_model_cfg, model_cfg = joint_configs(SERVE_JOINT)
    jv, jd = jax_model_cfg.visual, jax_model_cfg.decoder
    jax_init = JaxCaptionGenerator(jv, jd).init(
        jax.random.PRNGKey(3), jnp.asarray(want_ex[0]["vis_feats"][None]),
        jnp.asarray(want_ex[0]["input_caption_ids"][None]))
    jl, pl = [], []
    jit = jax.jit

    def recording_jit(fn, *a, **k):
        # records the loss of the JAX loop's jitted train_step
        step = jit(fn, *a, **k)
        if fn.__name__ != "train_step":
            return step

        def run(*args):
            out = step(*args)
            jl.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    _, want = jax_pretrain(want_ex, jv, jd, batch_size=3, epochs=2, lr=1e-3,
                           seed=3, verbose=False)
    monkeypatch.setattr(jax, "jit", jit)
    port_loss = pretrain_module.step_captioning_loss

    def recording_loss(*a):
        loss = port_loss(*a)
        pl.append(float(loss.detach()))
        return loss

    monkeypatch.setattr(pretrain_module, "step_captioning_loss",
                        recording_loss)
    init = _generator_state_dict(jax_init)
    # the JAX loop's initial weights in place of the port's seeded draw
    monkeypatch.setattr(pretrain_module, "_draw",
                        lambda shapes, seed, keys: {
                            k: init[k].reshape(s) for k, s in shapes.items()})
    gen = pretrain_caption_generator(
        ex, model_cfg.visual, model_cfg.decoder, batch_size=3, epochs=2,
        lr=1e-3, seed=3, verbose=False, ckpt_dir=str(tmp_path / "pre"),
        device="cpu")
    steps = 2 * (len(ex) // 3)
    assert len(pl) == len(jl) == steps
    for a, b in zip(pl, jl):
        _close(a, b, 1e-5)
    half = steps // 2
    for a, b in ((pl[:half], jl[:half]), (pl[half:], jl[half:])):
        _close(np.mean(a), np.mean(b), 1e-5)
    want = _generator_state_dict(want)
    state = gen.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        got = state[k].numpy()
        if k.endswith("key.bias"):
            for p in (got, v):
                assert np.abs(p - init[k]).max() <= 2 * 1e-3 * steps, k
            continue
        moved = np.abs(v - init[k]).max()
        assert moved > 0, k
        assert np.abs(got - v).max() <= 1e-3 * moved, k
    assert (tmp_path / "pre" / "caption_pretrain.pt").exists()


def test_init_moment_model_from_pretrain():
    _, model_cfg = joint_configs(SERVE_JOINT)
    gen = CaptionGenerator(model_cfg.visual, model_cfg.decoder,
                           in_dim=model_cfg.embed_dim)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(1.0)
    model = init_moment_model_from_pretrain(MomentModel(model_cfg), gen)
    state = model.state_dict()
    for k, v in gen.state_dict().items():
        assert torch.equal(state[f"clip4cap_model.{k}"], v)


def test_meters_and_profiling(tmp_path):
    """LossMeter and MetricsLogger as the JAX copies behave; trace() writes
    a torch.profiler Chrome trace into its directory, and is a no-op
    without one."""
    from hirest_tpu.utils.meters import LossMeter as JaxLossMeter
    from hirest_tpu_torch.utils.meters import LossMeter
    from hirest_tpu_torch.utils.profiling import (MetricsLogger, PhaseTimer,
                                                  trace)

    meters = (LossMeter(maxlen=3), JaxLossMeter(maxlen=3))
    for v in (1.0, 2.0, 4.0, 8.0):
        for m in meters:
            m.update(v)
    assert meters[0].val == meters[1].val == 14.0 / 3
    assert repr(meters[0]) == repr(meters[1]) and len(meters[0]) == 3

    log = MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    timer = PhaseTimer()
    with timer.phase("step"), trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with trace(None):
        pass
    log.log(3, loss=torch.tensor(0.5), task="moment_retrieval")
    log.close()
    rec = json.loads((tmp_path / "m" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5
    assert timer.report()["step"]["count"] == 1
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(
        traces[0].read_text())
