"""The multitask training and inference engine.

Counterpart of hirest_tpu/train/trainer.py::Trainer: the joint model, the
frozen EVA-CLIP text tower, the feature store, the frame buckets and the
split loaders; the training loop (`train`: the multitask schedule, one
optimizer step a batch, validation loss a task, BEST by validation loss,
LAST, the per-epoch JSONs, the test split scored with BEST), the split
predictions (`predict`/`evaluate`, in the evaluate.py JSON schemas), the
three prediction forwards (moment retrieval, iterative moment
segmentation, step captioning with the KV-cached beam) and the checkpoint
round trip.

Everything runs on `config.device`: CUDA unless "cpu" is asked for, never
a fallback. The host keeps the data-dependent parts the JAX package keeps
there: the moment trim of step captioning and, unless
`fused_segmentation`, the greedy walk of segmentation.

A training step is autograd over the plain modules (the JAX training code
reaches no Pallas kernel and has no custom_vjp) followed by the optax
semantics of train/optim.py. Dropout is live during the step only (the
model is in `train()` mode for it, `eval()` otherwise), drawn from one
`torch.Generator` seeded from (config.seed, step) each step, as the JAX
step folds the step into PRNGKey(seed); `dropout = False` turns it off.
Losses stay on the device and are fetched every 50 steps.

Checkpoints are `torch.save` of {"model": state dict, "opt_state",
"step", "epoch"} at `{ckpt_dir}/{name}.pt`; `load` of one with optimizer
state into a fresh trainer sets the optimizer up first, so Adam's moments,
its count and the accumulator are restored, not restarted. JAX `.msgpack`
checkpoints need flax and are not read; reference `.pth` files load with
`load_torch_checkpoint`.

`mesh_shape` ("data:N[,model:M]", parallel/mesh.py) trains over the ranks of
the process group, a rank a device, and computes what one process computes,
as the JAX mesh changes placement and not results. Every rank builds the
same loaders (batches padded to the batch size, batch_mask marking the real
rows) and takes its rows of each batch over 'data'; the decoder and encoder
layers are sharded over 'model' (parallel/tp.py). The losses' denominators
are summed over the data group, so the ranks' losses and gradients sum to
the whole batch's: the gradients (and the loss) cross the data group in
one flat all_reduce a step, before the optimizer, whose clipping norm
counts each shard once. Dropout draws the one-process mask and each rank
keeps its rows (models/caption.py::Dropout). Predictions are made on each
rank's rows and gathered in batch order, validation losses are global;
rank 0 alone writes the JSONs and checkpoints, which hold the full
(gathered) parameters and optimizer state.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from hirest_tpu_torch.config import EvaTextConfig, HirestConfig
from hirest_tpu_torch.data.annotations import (build_examples,
                                               caption_targets,
                                               load_annotations)
from hirest_tpu_torch.data.batching import TaskBatcher
from hirest_tpu_torch.data.features import FeatureStore
from hirest_tpu_torch.data.multitask import MultitaskSchedule
from hirest_tpu_torch.infer.beam import beam_search_cached
from hirest_tpu_torch.infer.segmentation import (iterative_segmentation,
                                                 iterative_segmentation_scan)
from hirest_tpu_torch.models.caption import Dropout
from hirest_tpu_torch.models.joint import MomentModel
from hirest_tpu_torch.native import trim_to_moment
from hirest_tpu_torch.parallel.collectives import (allgather_objects,
                                                   merge_prediction_lists)
from hirest_tpu_torch.tokenizers import clip_tokenize
from hirest_tpu_torch.train import losses as L
from hirest_tpu_torch.train.formatting import (format_moment_retrieval,
                                               format_moment_segmentation,
                                               format_step_captioning)
from hirest_tpu_torch.train.optim import (apply_updates, global_norm,
                                          grads_of, make_optimizer)
from hirest_tpu_torch.utils.device import resolve_device
from hirest_tpu_torch.utils.meters import LossMeter
from hirest_tpu_torch.utils.profiling import MetricsLogger, PhaseTimer, trace

BOS_ID, EOS_ID = 101, 102  # BERT [CLS] / [SEP]
FETCH_EVERY = 50  # steps between fetches of the device-side losses
TARGET_KEYS = {"moment_retrieval": "moment_retrieval_start_target",
               "moment_segmentation": "moment_segmentation_target",
               "step_captioning": "output_caption_ids"}


class Trainer:
    def __init__(
        self,
        config: HirestConfig,
        text_encoder_fn: Optional[Callable] = None,
        wordpiece_tokenizer=None,
        model: Optional[MomentModel] = None,
        feature_store: Optional[FeatureStore] = None,
        verbose: bool = True,
        model_config=None,
    ):
        self.config = config
        self.mesh = None
        if config.mesh_shape:
            from hirest_tpu_torch.parallel.mesh import make_mesh, parse_spec

            n_data = parse_spec(config.mesh_shape).get("data", 1)
            for name, bs in (("train_batch_size", config.train_batch_size),
                             ("eval_batch_size", config.eval_batch_size)):
                if bs % n_data:
                    raise ValueError(
                        f"{name}={bs} must be divisible by the mesh 'data' "
                        f"axis ({n_data}) so every device gets equal rows")
            self.mesh = make_mesh(config.mesh_shape)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        verbose = verbose and self.is_main
        if verbose and self.mesh is not None:
            print(f"mesh: {self.mesh.shape}")
        self.verbose = verbose
        self.device = resolve_device(config.device)
        self.model_cfg = model_config or config.joint_model_config()
        self.dtype = torch.bfloat16 if config.fp16 else torch.float32
        self.tokenizer = wordpiece_tokenizer
        vocab = getattr(wordpiece_tokenizer, "vocab", None)
        self.bos_id = vocab["[CLS]"] if vocab else BOS_ID
        self.eos_id = vocab["[SEP]"] if vocab else EOS_ID
        self.text_encoder_fn = text_encoder_fn or self._make_text_encoder()
        self.store = feature_store or FeatureStore(
            config.video_feature_dir or None, config.asr_dir,
            config.asr_feature_dir)
        self.buckets = tuple(config.frame_buckets)
        self.model = (model or self._init_params()).to(self.device).eval()
        self.shardings: dict = {}  # parameter name -> dim sharded over 'model'
        self._rows = None  # this rank's (first row, real rows) of a batch
        if self.mesh is not None:
            from hirest_tpu_torch.parallel.mesh import (apply_param_shardings,
                                                        replicate)

            replicate(self.mesh, self.model)
            self.shardings = {k: d for k, d in apply_param_shardings(
                self.model, self.mesh).items() if d is not None}
        self.dropout = True  # dropout live in training steps
        self.dropout_gen = torch.Generator(device=self.device)
        self._dropouts = [m for m in self.model.modules()
                          if isinstance(m, Dropout)]
        for mod in self._dropouts:
            mod.generator = self.dropout_gen
        self.tx = None
        self.opt_state = None
        self.step = 0
        self.epoch = self.start_epoch = 0
        self.loaders = self._build_loaders()

    # -- construction ----------------------------------------------------

    def _make_text_encoder(self):
        """The EVA-CLIP text tower as a frozen feature function on the
        device. Loads `eva_clip_psz14.pt` from pretrained_dir when present;
        otherwise seeded random weights (for tests and scratch runs, loudly
        warned)."""
        from hirest_tpu_torch.models.convert import load_torch_ckpt
        from hirest_tpu_torch.models.eva_clip import eva_text_encoder
        from hirest_tpu_torch.utils.init import random_eva_text_state_dict

        text_cfg = EvaTextConfig()
        ckpt = os.path.join(self.config.pretrained_dir, "eva_clip_psz14.pt")
        if os.path.exists(ckpt):
            sd = load_torch_ckpt(ckpt)
            if self.verbose:
                print(f"Loaded EVA-CLIP text tower from {ckpt}")
        else:
            sd = random_eva_text_state_dict(text_cfg, seed=0)
            print(f"WARNING: {ckpt} not found - EVA text tower is "
                  f"random-init")
        return eva_text_encoder(sd, text_cfg, self.dtype, self.device)

    def _init_params(self) -> MomentModel:
        """The joint model with seeded random weights (config.seed), its
        encoder and decoder overwritten by the pretrained CLIP4Caption
        weights when present (modeling.py:102-110)."""
        from hirest_tpu_torch.models.convert import (init_from_clip4caption,
                                                     load_torch_ckpt)
        from hirest_tpu_torch.utils.init import random_moment_state_dict

        with torch.device("meta"):
            model = MomentModel(self.model_cfg, dtype=self.dtype)
        sd = random_moment_state_dict(self.model_cfg, seed=self.config.seed)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                              assign=True)
        bin_path = os.path.join(self.config.pretrained_dir,
                                "clip4caption_vit-b-32_model.bin")
        if os.path.exists(bin_path):
            init_from_clip4caption(model, load_torch_ckpt(bin_path))
            if self.verbose:
                print(f"Initialized encoder/decoder from {bin_path}")
        return model

    def _build_loaders(self) -> dict:
        """split -> task -> TaskBatcher over the split files of data_dir
        (the train split shuffled per epoch; a missing file is skipped)."""
        cfg = self.config
        loaders: dict = {}
        if not cfg.data_dir:
            return loaders
        for split in ("train", "val", "test"):
            path = os.path.join(cfg.data_dir, f"all_data_{split}.json")
            if not os.path.exists(path):
                continue
            anns = load_annotations(path)
            loaders[split] = {}
            for task in cfg.tasks:
                ex = build_examples(anns, task, cfg.n_model_frames,
                                    is_train=(split == "train"),
                                    end_to_end=cfg.end_to_end)
                if task == "step_captioning" and self.tokenizer is not None:
                    for e in ex:
                        e.update(caption_targets(
                            self.tokenizer, e["target_text_raw"],
                            cfg.max_words))
                bs = (cfg.train_batch_size if split == "train"
                      else cfg.eval_batch_size)
                # under a mesh a rank stands for a JAX device, not a JAX
                # process: every rank iterates the whole split, its batches
                # padded to the batch size, and takes its rows (_shard)
                loaders[split][task] = TaskBatcher(
                    ex, batch_size=bs, store=self.store, buckets=self.buckets,
                    shuffle=(split == "train"), seed=cfg.seed,
                    pad_batch=self.mesh is not None)
        return loaders

    # -- the mesh ------------------------------------------------------------

    def _group(self, axis: str):
        return None if self.mesh is None else self.mesh.group(axis)

    def _sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x summed over this rank's group along axis (x where none)."""
        group = self._group(axis)
        if group is None:
            return x
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    def _data_total(self):
        if self._group("data") is None:
            return None
        return lambda x: self._sum(x, "data")

    def _shard(self, batch: dict) -> dict:
        """This rank's rows over 'data' of a host batch padded to the batch
        size: its rows of every per-row array, its real rows of every
        per-row list, and its rows' prompts (padding repeats the first)
        under "row_prompts". Notes the rows for dropout. The identity
        without a mesh."""
        self._rows = None
        if self.mesh is None:
            return batch
        n_real, n_rows = len(batch["prompts"]), len(batch["batch_mask"])
        rows = n_rows // self.mesh.size("data")
        lo = self.mesh.index("data") * rows
        hi = lo + rows
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim and len(v) == n_rows:
                out[k] = v[lo:hi]
            elif isinstance(v, list) and len(v) == n_real:
                out[k] = v[lo:min(hi, n_real)]
            else:
                out[k] = v
        prompts = list(batch["prompts"])
        out["row_prompts"] = (prompts + prompts[:1] * (n_rows - n_real))[
            lo:hi]
        self._rows = (lo, n_real)
        return out

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole model's gradient: each tensor
        sharded over 'model' counted once across the group, each replicated
        one once."""
        if self._group("model") is None:
            return global_norm(grads)
        zero = next(iter(grads.values())).new_zeros(())
        rep = sum(((g * g).sum() for k, g in grads.items()
                   if k not in self.shardings), zero)
        sharded = sum(((g * g).sum() for k, g in grads.items()
                       if k in self.shardings), zero)
        return torch.sqrt(rep + self._sum(sharded, "model"))

    # -- batch prep -------------------------------------------------------

    def _prepare(self, batch: dict, task: str) -> dict:
        """Host batch dict -> tensors on the device (with the text encode
        and the step-captioning moment trim). Prompts are repeat-padded to
        the array batch rows where the batch was padded (batch_mask)."""
        n_real = len(batch["prompts"])
        n_rows = len(batch["batch_mask"]) if "batch_mask" in batch else n_real
        prompts = batch.get("row_prompts") or (
            list(batch["prompts"]) + [batch["prompts"][0]] * (n_rows - n_real))
        text_feat = self.text_encoder_fn(clip_tokenize(prompts))

        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(self.device)

        # a copy made outside inference mode: autograd may save it
        arrs = {"text_feat": torch.as_tensor(
            text_feat, dtype=torch.float32, device=self.device).clone()}
        if task == "step_captioning":
            mf = self.config.max_frames_step_captioning
            keys = ["vis_feats"] + (["asr_feats"] if "asr_feats" in batch
                                    else [])
            for key in keys:
                arrs[key] = dev(np.stack([
                    trim_to_moment(batch[key][i], batch["moment_mask"][i], mf)
                    for i in range(n_rows)]))
            extra = ("input_caption_ids", "output_caption_ids",
                     "decoder_mask")
        else:
            extra = ("vis_feats", "video_mask", "moment_mask", "asr_feats",
                     "moment_retrieval_start_target",
                     "moment_retrieval_end_target",
                     "moment_segmentation_target", "prev_boundary_mask")
        for key in extra + ("batch_mask",):
            if key in batch:
                arrs[key] = dev(batch[key])
        return arrs

    # -- training -----------------------------------------------------------

    def _loss_for_task(self, task: str, arrs: dict) -> torch.Tensor:
        m = self.model
        total = self._data_total()
        if task == "moment_retrieval":
            out = m.moment_retrieval(arrs["vis_feats"], arrs["text_feat"],
                                     arrs["video_mask"], arrs["moment_mask"],
                                     arrs.get("asr_feats"))
            return L.moment_retrieval_loss(
                out["start_logits"], out["end_logits"],
                arrs["moment_retrieval_start_target"],
                arrs["moment_retrieval_end_target"], arrs["moment_mask"],
                arrs.get("batch_mask"), total)
        if task == "moment_segmentation":
            logits = m.moment_segmentation(
                arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
                arrs["moment_mask"], arrs.get("asr_feats"),
                arrs["prev_boundary_mask"])
            return L.moment_segmentation_loss(
                logits, arrs["moment_segmentation_target"],
                arrs["moment_mask"], arrs.get("batch_mask"), total)
        if task == "step_captioning":
            vis = m.caption_encode(arrs["vis_feats"], arrs["text_feat"],
                                   arrs.get("asr_feats"))
            logits = m.caption_logits(vis, arrs["input_caption_ids"],
                                      arrs["decoder_mask"])
            return L.step_captioning_loss(logits, arrs["output_caption_ids"],
                                          arrs.get("batch_mask"), total)
        raise ValueError(task)

    def loss_and_grads(self, task: str, arrs: dict) -> tuple:
        """One batch's loss with dropout live (unless `dropout` is False),
        its masks drawn from (config.seed, step), and the gradient of every
        parameter (zeros where the loss does not reach it). Returns (the
        loss, detached, on the device; {name: gradient}). Under a mesh both
        are the whole batch's: this rank's share summed over the data group
        in one flat all_reduce (a sharded parameter's gradient is this
        rank's shard of it)."""
        self.dropout_gen.manual_seed(self.config.seed * 2 ** 32 + self.step)
        for mod in self._dropouts:
            mod.rows = self._rows
        self.model.zero_grad(set_to_none=True)
        self.model.train(self.dropout)
        try:
            loss = self._loss_for_task(task, arrs)
            loss.backward()
        finally:
            self.model.eval()
        loss = loss.detach()
        grads = grads_of(dict(self.model.named_parameters()))
        if self._group("data") is None:
            return loss, grads
        flat = self._sum(torch.cat([g.reshape(-1) for g in grads.values()]
                                   + [loss.reshape(1)]), "data")
        out, at = {}, 0
        for k, g in grads.items():
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return flat[at], out

    def apply_gradients(self, grads: dict) -> None:
        """One optimizer update of the parameters from `grads`."""
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     params)
            apply_updates(params, updates)
        self.model.zero_grad(set_to_none=True)

    def train_step(self, task: str, arrs: dict) -> torch.Tensor:
        loss, grads = self.loss_and_grads(task, arrs)
        self.apply_gradients(grads)
        self.step += 1
        return loss

    @torch.inference_mode()
    def _eval_loss(self, task: str, arrs: dict) -> float:
        return float(self._sum(self._loss_for_task(task, arrs), "data"))

    def setup_optimizer(self, steps_per_epoch: int):
        cfg = self.config
        total = ((steps_per_epoch // cfg.gradient_accumulation_steps)
                 * cfg.epochs)
        self.tx = make_optimizer(cfg.lr, cfg.warmup_steps, max(total, 1),
                                 cfg.clip_grad_norm, cfg.weight_decay,
                                 cfg.gradient_accumulation_steps,
                                 norm_fn=self.grad_norm)
        # keep an optimizer state restored by load(): re-initializing here
        # would restart Adam's moments, the accumulator and the schedule's
        # count on resume (the reference's flaw, trainer_base.py:109-126)
        if self.opt_state is None:
            self.opt_state = self.tx.init(
                dict(self.model.named_parameters()))

    def _dump(self, name: str, obj) -> None:
        if not self.is_main:
            return
        os.makedirs(self.config.ckpt_dir, exist_ok=True)
        with open(os.path.join(self.config.ckpt_dir, name), "w") as f:
            json.dump(obj, f, indent=4)

    def train(self) -> dict:
        cfg = self.config
        if "step_captioning" in cfg.tasks and self.tokenizer is None:
            raise ValueError(
                "step-captioning TRAINING needs a WordPiece tokenizer for the "
                "teacher-forcing targets: put bert-base-uncased vocab.txt in "
                f"{cfg.pretrained_dir} (inference-only runs work without it)")
        if "val" not in self.loaders:
            # before the first epoch, not at its end: BEST is chosen by
            # validation loss
            val = os.path.join(cfg.data_dir or "<data_dir>",
                               "all_data_val.json")
            raise ValueError(f"validation split not found: expected {val} "
                             "(train() selects BEST by val loss)")
        schedule = MultitaskSchedule(self.loaders["train"], shuffle=True)
        self.setup_optimizer(len(schedule))

        best_valid, best_epoch = float("inf"), 0
        meter = LossMeter()
        timer = PhaseTimer()
        metrics = MetricsLogger(cfg.metrics_log if self.is_main else None)
        traced = False
        pending: list = []  # device scalars, fetched every FETCH_EVERY steps

        for epoch in range(self.start_epoch, self.start_epoch + cfg.epochs):
            self.epoch = epoch
            schedule.set_epoch(epoch)
            it = iter(schedule)
            if cfg.num_workers > 0:
                from hirest_tpu_torch.data.prefetch import prefetch

                it = prefetch(it, depth=max(2, cfg.num_workers))
            while True:
                with timer.phase("data"):
                    batch = next(it, None)
                if batch is None:
                    break
                task = batch["tasks"][0]
                with timer.phase("prepare"):
                    arrs = self._prepare(self._shard(batch), task)
                with timer.phase("train_step"), \
                        trace(None if traced or not self.is_main
                              else cfg.trace_dir):
                    traced = True
                    pending.append(self.train_step(task, arrs))
                if self.step % FETCH_EVERY == 0:
                    for loss in pending:
                        meter.update(float(loss))
                    pending.clear()
                    metrics.log(self.step, epoch=epoch, task=task,
                                loss=meter.val)
                if cfg.save_every_steps and \
                        self.step % cfg.save_every_steps == 0:
                    self.save("LAST")  # a periodic snapshot
            for loss in pending:  # the epoch's tail
                meter.update(float(loss))
            pending.clear()

            val_loss = 0.0
            epoch_results = {}
            for task in cfg.tasks:
                has_target = task != "moment_segmentation"
                res = self.evaluate(self.loaders["val"][task], task,
                                    has_target=has_target)
                epoch_results[task] = res
                if has_target and "loss" in res:
                    val_loss += res["loss"]

            metrics.log(self.step, epoch=epoch, train_loss=meter.val,
                        val_loss=val_loss, **{f"time_{k}": v["total_s"]
                                              for k, v in
                                              timer.report().items()})
            if self.verbose:
                print(f"Epoch {epoch} | train loss {meter.val:.4f} | "
                      f"val loss {val_loss:.4f} | phases {timer.report()}")
                for task, res in epoch_results.items():
                    self._dump(f"{task}_epoch_{str(epoch).zfill(3)}.json",
                               res)
            timer.reset()
            if val_loss < best_valid or epoch == self.start_epoch:
                best_valid, best_epoch = val_loss, epoch
                self.save("BEST")
        self.save("LAST")
        metrics.close()

        if self.verbose:
            print("Best Epoch:", best_epoch)
        self.load(os.path.join(cfg.ckpt_dir, "BEST"))
        results = {}
        if "test" in self.loaders:
            for task in cfg.tasks:
                results[task] = self.evaluate(self.loaders["test"][task],
                                              task, has_target=False)
                self._dump(f"test_{task}_BEST.json", results[task])
        return results

    # -- split predictions ------------------------------------------------

    def predict(self, batcher: TaskBatcher, task: str,
                has_target: bool = False) -> dict:
        """Predictions over one task's batches in the evaluate.py schema,
        with the mean loss over the batches that carry targets when
        has_target. Under a mesh each rank predicts its rows of each batch,
        and the lists are gathered in batch order."""
        cfg = self.config
        losses, per_batch = [], []
        batches = batcher
        if cfg.num_workers > 0:
            from hirest_tpu_torch.data.prefetch import prefetch

            batches = prefetch(iter(batcher), depth=max(2, cfg.num_workers))
        for batch in batches:
            predictions, targets = [], []
            batch = self._shard(batch)
            arrs = self._prepare(batch, task)
            if has_target and TARGET_KEYS[task] in batch:
                losses.append(self._eval_loss(task, arrs))
            # host lists carry the real rows; arrays may be padded
            n_real = len(batch["prompts"])
            if task == "moment_retrieval":
                preds = self._predict_moment_retrieval(arrs)
                if "moment_retrieval_start_target" in batch:
                    targets.extend(np.stack([
                        batch["moment_retrieval_start_target"][:n_real],
                        batch["moment_retrieval_end_target"][:n_real]],
                        axis=1).tolist())
            elif task == "moment_segmentation":
                preds = self._predict_moment_segmentation(arrs, batch)
                targets.extend(batch.get("all_bound_frames",
                                         [[]] * n_real)[:n_real])
            elif task == "step_captioning":
                preds = self._predict_step_captioning(arrs)
                targets.extend(batch.get("target_text_raw",
                                         [""] * n_real)[:n_real])
            else:
                raise ValueError(task)
            predictions.extend(list(preds)[:n_real])
            per_batch.append({"predictions": predictions,
                              "targets": targets,
                              "fnames": list(batch["video_fnames"]),
                              "prompts": list(batch["prompts"]),
                              "durations": list(batch["video_duration"])})

        group = self._group("data")
        if group is not None:  # each batch's ranks in rank order
            ranks = allgather_objects(per_batch, group)
            per_batch = [shard[i] for i in range(len(per_batch))
                         for shard in ranks]
        merged = merge_prediction_lists(per_batch)
        predictions, targets, fnames, prompts, durations = (
            merged.get(k, []) for k in ("predictions", "targets", "fnames",
                                        "prompts", "durations"))
        loss = float(np.mean(losses)) if losses else None
        if task == "moment_retrieval":
            return format_moment_retrieval(
                prompts, fnames, durations, predictions, cfg.n_model_frames,
                targets if has_target else None, loss)
        if task == "moment_segmentation":
            return format_moment_segmentation(
                fnames, durations, predictions, cfg.n_model_frames, targets,
                loss)
        return format_step_captioning(fnames, durations, predictions,
                                      targets if has_target else None, loss)

    def evaluate(self, batcher: TaskBatcher, task: str,
                 has_target: bool = False) -> dict:
        return self.predict(batcher, task, has_target=has_target)

    # -- prediction forwards ---------------------------------------------

    @torch.inference_mode()
    def _predict_moment_retrieval(self, arrs) -> list:
        out = self.model.moment_retrieval(
            arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
            arrs["moment_mask"], arrs.get("asr_feats"))
        valid = arrs["video_mask"] > 0
        start = torch.where(valid, out["start_logits"], -1e10)
        end = torch.where(valid, out["end_logits"], -1e10)
        return torch.stack([start.argmax(1), end.argmax(1)], 1).cpu().tolist()

    def _segment_scores(self, arrs, moment_mask, prev_boundary_mask):
        logits = self.model.moment_segmentation(
            arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
            moment_mask, arrs.get("asr_feats"), prev_boundary_mask)
        masked = torch.where(moment_mask > 0, logits,
                             -torch.finfo(torch.float32).max)
        return torch.softmax(masked, dim=1)

    @torch.inference_mode()
    def _predict_moment_segmentation(self, arrs, batch) -> list:
        cfg = self.config
        t = arrs["vis_feats"].shape[1]
        bounds = np.asarray(batch["moment_bound_frames"])
        if cfg.fused_segmentation:
            # the whole loop on the device, one fetch at the end
            return iterative_segmentation_scan(
                lambda mm, pbm: self._segment_scores(arrs, mm, pbm), bounds,
                t, cfg.moment_segmentation_difference_threshold,
                cfg.moment_segmentation_max_iterations, device=self.device)

        def score_fn(mm, pbm):
            mm, pbm = (torch.from_numpy(mm).to(self.device),
                       torch.from_numpy(pbm).to(self.device))
            return self._segment_scores(arrs, mm, pbm).cpu().numpy()

        return iterative_segmentation(
            score_fn, bounds, t, cfg.moment_segmentation_difference_threshold,
            cfg.moment_segmentation_max_iterations)

    @torch.inference_mode()
    def _predict_step_captioning(self, arrs) -> list:
        cfg = self.config
        beam, max_words = cfg.num_beams, cfg.max_words
        b = arrs["vis_feats"].shape[0]
        vis = self.model.caption_encode(arrs["vis_feats"], arrs["text_feat"],
                                        arrs.get("asr_feats"))
        dec = self.model.decoder
        cross_kv = dec.cross_kv(vis.repeat_interleave(beam, dim=0))

        def step_fn(last, t, cache):
            return dec.decode_step(last, t, cross_kv, cache)

        def gather_fn(cache, src):
            return tuple((k[src], v[src]) for k, v in cache)

        ids, _ = beam_search_cached(
            step_fn, gather_fn, dec.init_cache(b * beam, max_words + 1), b,
            beam, max_words, self.bos_id, self.eos_id, device=self.device)
        out = []
        for row in ids.cpu().numpy():
            if self.tokenizer is not None:
                from hirest_tpu_torch.tokenizers.wordpiece import \
                    detokenize_caption

                toks = self.tokenizer.convert_ids_to_tokens(
                    [int(x) for x in row])
                out.append(detokenize_caption(toks))
            else:
                out.append(" ".join(str(int(x)) for x in row if x != 0))
        return out

    # -- checkpoints -------------------------------------------------------

    def _resharded(self, tree, gather: bool):
        """A copy of a state dict or optimizer state (nested dicts keyed by
        parameter name) with each tensor of a parameter sharded over
        'model' gathered whole (gather) or cut to this rank's shard."""
        if isinstance(tree, dict):
            return {k: (self._reshard(k, v, gather)
                        if isinstance(v, torch.Tensor) else
                        self._resharded(v, gather)) for k, v in tree.items()}
        return tree

    def _reshard(self, name: str, t: torch.Tensor, gather: bool):
        dim = self.shardings.get(name)
        if dim is None:
            return t
        size, index = self.mesh.size("model"), self.mesh.index("model")
        if not gather:
            n = t.shape[dim] // size
            return t.narrow(dim, index * n, n).contiguous()
        shape = list(t.shape)
        shape[dim] *= size
        full = t.new_zeros(shape)
        full.narrow(dim, index * t.shape[dim], t.shape[dim]).copy_(t)
        return self._sum(full, "model")

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.devices.size > 1:
            torch.distributed.barrier()

    def save(self, name: str) -> None:
        """`{ckpt_dir}/{name}.pt` with the full parameters and optimizer
        state (gathered over 'model'), written by rank 0."""
        path = os.path.join(self.config.ckpt_dir, f"{name}.pt")
        state = {"model": self._resharded(self.model.state_dict(), True),
                 "step": self.step, "epoch": self.epoch}
        if self.opt_state is not None:
            state["opt_state"] = self._resharded(self.opt_state, True)
        if self.is_main:
            os.makedirs(self.config.ckpt_dir, exist_ok=True)
            torch.save(state, path)
        self._barrier()
        if self.verbose:
            print("Model saved at", path)

    def load(self, path: str) -> None:
        """Restore a checkpoint of `save` (".pt" may be left off)."""
        if not path.endswith(".pt"):
            path = path + ".pt"
        state = torch.load(path, map_location=self.device, weights_only=True)
        if (self.opt_state is None and "train" in self.loaders
                and "opt_state" in state):
            # a fresh-process resume: set the optimizer up first, so its
            # state below is restored rather than dropped
            self.setup_optimizer(len(MultitaskSchedule(
                self.loaders["train"], shuffle=True)))
        self.model.load_state_dict(self._resharded(state["model"], False))
        self.step = int(state["step"])
        self.start_epoch = int(state.get("epoch", 0))
        if self.opt_state is not None and "opt_state" in state:
            opt_state = self._resharded(state["opt_state"], False)
            _check_same_structure(self.opt_state, opt_state)
            self.opt_state = opt_state
        if self.verbose:
            print("Model loaded from", path)

    def load_torch_checkpoint(self, ckpt_path: str):
        """Load a reference-format .pth joint checkpoint (its key surgery
        included) into the model."""
        from hirest_tpu_torch.models.convert import (load_moment_state_dict,
                                                     load_torch_ckpt)

        if self.shardings:  # load whole, then keep this rank's shards
            full = load_moment_state_dict(
                MomentModel(self.model_cfg, dtype=self.dtype),
                load_torch_ckpt(ckpt_path))
            self.model.load_state_dict(
                self._resharded(full.state_dict(), False))
        else:
            self.model = load_moment_state_dict(
                self.model, load_torch_ckpt(ckpt_path)).to(self.device)
        if self.verbose:
            print("Model loaded from", ckpt_path)


def _check_same_structure(want, got, path: str = "opt_state") -> None:
    """Raise ValueError unless `got` has `want`'s keys and tensor shapes
    throughout: the optimizer set up here and the one saved differ."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint {path} does not match the "
                             f"optimizer set up: keys differ")
        for k in want:
            _check_same_structure(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor) and (
            not isinstance(got, torch.Tensor) or got.shape != want.shape):
        raise ValueError(f"checkpoint {path} does not match the optimizer "
                         f"set up")
