"""The port's data and tensor parallelism (hirest_tpu_torch/parallel/ and
Trainer under mesh_shape) on the CPU, against one process and against the
JAX package.

A rank is a process: the 2-rank cases spawn this file as a worker script
(`python tests/test_torch_parallel.py <result> <json>`), two processes over
gloo joined by a `file://` init_method (no ports, so no races between
test workers), each with a timeout and killed on failure. The workers
import torch and the port only. JAX is imported inside the tests that
compare with it.

The bars are chip_smoke.py's parallel phase's: losses and gradient norms
within 1e-6 relative, parameters within 1e-5 of each tensor's largest
magnitude (bar the leaves whose gradient is zero in exact arithmetic,
where Adam moves f32 noise by up to the learning rate), the same
predictions; and the JAX mesh trainer's per-step losses within 1e-5.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TASKS = ("moment_retrieval", "moment_segmentation", "step_captioning")
STEPS_A_TASK = 3
SPECS = {"data:2": 2, "model:2": 2, "data:2,model:2": 4}  # mesh -> ranks
WORKER_TIMEOUT = 240  # seconds a 2-process run may take


# -- the worker (also run in-process for the one-process reference) --------


def _port_config(kw: dict):
    from hirest_tpu_torch import config as port_config

    spec = dict(kw["joint"])
    visual = port_config.VisualEncoderConfig(**spec.pop("visual"))
    decoder = port_config.DecoderConfig(**spec.pop("decoder"))
    return (port_config.HirestConfig(**kw["config"]),
            port_config.JointModelConfig(visual=visual, decoder=decoder,
                                         **spec))


def _text_fn(ids):
    """test_torch_train.py's deterministic text feature of the ids."""
    w = np.random.default_rng(7).normal(size=(77, 1024)).astype(np.float32)
    return (np.asarray(ids, np.float32) / 49407.0) @ w


def _trainer(kw: dict, verbose: bool = False):
    from hirest_tpu_torch.models.joint import MomentModel
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer
    from hirest_tpu_torch.train.trainer import Trainer

    cfg, model_cfg = _port_config(kw)
    model = MomentModel(model_cfg)
    model.load_state_dict(torch.load(kw["weights"], weights_only=True))
    vocab = os.path.join(cfg.pretrained_dir, "vocab.txt")
    trainer = Trainer(cfg, text_encoder_fn=_text_fn,
                      wordpiece_tokenizer=WordPieceTokenizer(vocab),
                      model=model, verbose=verbose, model_config=model_cfg)
    trainer.dropout = kw.get("dropout", True)
    return trainer


def _full_params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer._resharded(
        trainer.model.state_dict(), True).items()}


def _one_step(trainer, task: str, batch: dict) -> tuple:
    arrs = trainer._prepare(trainer._shard(batch), task)
    loss, grads = trainer.loss_and_grads(task, arrs)
    norm = trainer.grad_norm(grads)
    trainer.apply_gradients(grads)
    trainer.step += 1
    return float(loss), float(norm)


def run(kw: dict) -> dict:
    """One rank's (or the one process's) run: the mesh's layout and an
    object gather; STEPS_A_TASK training steps a task on the train split's
    first batches, dropout live, with each step's loss and gradient norm;
    the full parameters after them; a checkpoint, then one more step; the
    test and val predictions. Or, with kw["train"], Trainer.train() with
    each step's loss."""
    from hirest_tpu_torch.parallel.collectives import allgather_objects
    from hirest_tpu_torch.parallel.mesh import param_shardings

    trainer = _trainer(kw)
    mesh = trainer.mesh
    out = {"rank": 0 if mesh is None else mesh.rank}
    if kw.get("train"):
        losses = []
        step = trainer.train_step
        trainer.train_step = lambda task, arrs: losses.append(
            (task, float(step(task, arrs)))) or torch.tensor(losses[-1][1])
        out["results"] = trainer.train()
        out["losses"] = losses
        return out
    if mesh is not None:
        out["layout"] = {"data": mesh.index("data"),
                         "model": mesh.index("model"), "shape": mesh.shape}
        out["gathered"] = allgather_objects({"rank": mesh.rank,
                                             "pair": (1, 2)})
        group = mesh.group("data")  # None: this rank alone on the axis
        out["data_gathered"] = (None if group is None else
                                allgather_objects([mesh.rank], group))
        out["shardings"] = trainer.shardings
        out["param_shardings"] = param_shardings(trainer.model, mesh)
    loaders = trainer.loaders
    trainer.setup_optimizer(len(loaders["train"]["step_captioning"]))
    out["steps"] = []
    for task in TASKS:
        for i, batch in zip(range(STEPS_A_TASK), loaders["train"][task]):
            loss, norm = _one_step(trainer, task, batch)
            out["steps"].append({
                "task": task, "loss": loss, "norm": norm,
                "n_real": len(batch["prompts"]),
                "local_real": len(trainer._shard(batch)["prompts"])})
    out["params"] = _full_params(trainer)
    trainer.save("MESH")
    batch = next(iter(loaders["train"]["moment_retrieval"]))
    out["next"] = _one_step(trainer, "moment_retrieval", batch)
    out["next_params"] = _full_params(trainer)
    out["predictions"] = {
        f"{split}/{task}": trainer.evaluate(loaders[split][task], task,
                                            has_target=split == "val")
        for split in ("test", "val") for task in TASKS}
    from hirest_tpu_torch.infer.pipeline import run_end_to_end

    out["end_to_end"] = run_end_to_end(trainer)
    return out


def _worker_main(result: str, args: str) -> None:
    from hirest_tpu_torch.parallel.mesh import init_distributed

    kw = json.loads(args)
    torch.set_num_threads(2)
    init_distributed(device="cpu", init_method=kw["init"],
                     rank=kw["rank"], world_size=kw["world"])
    torch.save(run(kw), result)


# -- the harness ------------------------------------------------------------


def _spawn(tmp_path: Path, tag: str, kw: dict, world: int = 2) -> list:
    """Run `run(kw)` on `world` ranks, each a process -> their results in
    rank order. Fails (and kills the rest) when one fails or times out."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="2")
    init = f"file://{tmp_path / f'{tag}.init'}"
    procs, results = [], []
    for rank in range(world):
        result = tmp_path / f"{tag}.{rank}.pt"
        args = json.dumps(dict(kw, init=init, rank=rank, world=world))
        log = open(tmp_path / f"{tag}.{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(result), args], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
        results.append(result)
    try:
        for proc, _ in procs:
            proc.wait(timeout=WORKER_TIMEOUT)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        text = (tmp_path / f"{tag}.{rank}.log").read_text()
        assert proc.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return [torch.load(r, weights_only=False) for r in results]


def _split_kw(root: Path, **config) -> dict:
    """A synthetic split (torch_port_util.write_split), the shared seeded
    weights (joint_state_dict of SERVE_JOINT) and the trainer's
    config, batches of 6 (the train split's 8 moment retrieval examples
    make a second batch of 2 real rows: under data:2 rank 1 gets none)."""
    from torch_port_util import SERVE_JOINT, joint_state_dict, write_split

    data, feats, pre = write_split(root)
    weights = root / "weights.pt"
    torch.save({k: torch.from_numpy(v)
                for k, v in joint_state_dict(SERVE_JOINT).items()}, weights)
    cfg = dict(data_dir=str(data), video_feature_dir=str(feats),
               pretrained_dir=str(pre), ckpt_dir=str(root / "ckpt"),
               task_moment_retrieval=True, task_moment_segmentation=True,
               task_step_captioning=True, train_batch_size=6,
               eval_batch_size=6, num_beams=2, max_words=8, epochs=1,
               moment_segmentation_max_iterations=4, frame_buckets=[64],
               num_workers=0, lr=1e-3, warmup_steps=0.2, clip_grad_norm=1.0,
               device="cpu")
    cfg.update(config)
    return {"config": cfg, "joint": SERVE_JOINT, "weights": str(weights)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run (in this process) and the data:2, model:2 (two
    processes each) and data:2,model:2 (four) runs on one split and one
    set of weights."""
    root = tmp_path_factory.mktemp("parallel")
    kw = _split_kw(root)
    out = {"one": run(dict(kw, config=dict(kw["config"],
                                           ckpt_dir=str(root / "one"))))}
    for spec, world in SPECS.items():
        out[spec] = _spawn(root, _tag(spec), dict(kw, config=dict(
            kw["config"], mesh_shape=spec, ckpt_dir=str(root / _tag(spec)))),
            world)
    out["kw"], out["root"] = kw, root
    return out


def _tag(spec: str) -> str:
    return spec.replace(":", "").replace(",", "_")


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _zero_in_exact_arithmetic(name: str, layers: int) -> bool:
    """test_torch_train.py's leaves whose gradient is zero in exact
    arithmetic (every key bias; the segmentation head's bias and the last
    encoder layer's output LayerNorm bias), over all three tasks."""
    return name.endswith("key.bias") or name in (
        "segment_predictor.0.bias",
        f"clip4cap_model.visual.encoder.layer.{layers - 1}.output."
        "LayerNorm.bias")


def _assert_params_close(got: dict, want: dict, kw: dict) -> None:
    layers = kw["joint"]["visual"]["num_hidden_layers"]
    assert set(got) == set(want)
    for k, w in want.items():
        if _zero_in_exact_arithmetic(k, layers):
            continue
        err = (got[k] - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (k, err)


# -- the mesh ---------------------------------------------------------------


def test_make_mesh_parses_specs_and_checks_the_world():
    """One process: "data:1", "data:1,model:1" and no spec all make a
    one-rank mesh without groups; a mesh of more ranks than the world is
    a ValueError (a rank is a device), as are repeated axes."""
    from hirest_tpu_torch.parallel.mesh import make_mesh

    for spec in (None, "data:1", "data:1,model:1"):
        mesh = make_mesh(spec)
        assert mesh.size("data") == mesh.size("model") == 1
        assert mesh.group("data") is None and mesh.group("model") is None
    assert make_mesh("data:1,model:1").shape == {"data": 1, "model": 1}
    assert make_mesh(None).axis_names == ("data",)
    for bad in ("data:2", "data:4,model:2", "data:1,data:1"):
        with pytest.raises(ValueError):
            make_mesh(bad)


@pytest.mark.parametrize("spec", list(SPECS))
def test_ranks_lay_out_row_major_and_gather_objects(runs, spec):
    """rank = d * M + m; every rank's JSON-round-tripped object comes back
    in rank order (the tuple as a list); the data group's gather holds the
    ranks of this rank's model column, and under model:2 a rank is alone
    on the data axis (no group)."""
    ranks, world = runs[spec], SPECS[spec]
    shape = {a: int(n) for a, n in (p.split(":") for p in spec.split(","))}
    m = shape.get("model", 1)
    for rank, res in enumerate(ranks):
        lay = res["layout"]
        assert lay["shape"] == shape
        assert lay["data"] * m + lay["model"] == rank
        assert res["gathered"] == [{"rank": r, "pair": [1, 2]}
                                   for r in range(world)]
        column = [[r] for r in range(world) if r % m == rank % m]
        assert res["data_gathered"] == (column if "data" in shape
                                        else None)


def test_objects_gather_and_merge_as_jax_on_one_process():
    """allgather_objects is the identity on one process and
    merge_prediction_lists concatenates as JAX's does."""
    from hirest_tpu.parallel.collectives import \
        allgather_objects as jax_gather
    from hirest_tpu.parallel.collectives import \
        merge_prediction_lists as jax_merge
    from hirest_tpu_torch.parallel.collectives import (allgather_objects,
                                                       merge_prediction_lists)

    obj = {"predictions": [[1, 2]], "loss": 0.5}
    assert allgather_objects(obj) == jax_gather(obj) == [obj]
    shards = [{"a": [1], "b": [[2]], "tag": "x"}, {"a": [3, 4], "b": [],
                                                    "tag": "y"}]
    assert merge_prediction_lists(shards) == jax_merge(shards)


def test_param_shardings_equal_jax_tp_rules(runs):
    """The port's sharded parameter set on MomentModel under model:2 is the
    JAX TP rules' on the same weights under a 'model' axis of 2, names
    mapped by moment_model_from_jax (each JAX leaf marked by its index),
    the kernels' dim transposed."""
    import jax
    from torch_port_util import (SERVE_JOINT, jax_joint_params,
                                 joint_state_dict)

    from hirest_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from hirest_tpu.parallel.mesh import param_shardings as jax_shardings
    from hirest_tpu_torch.models.convert import moment_model_from_jax

    params = jax.tree_util.tree_map(np.asarray, jax_joint_params(
        joint_state_dict(SERVE_JOINT), SERVE_JOINT))
    specs = jax_shardings(params, jax_make_mesh("data:4,model:2"))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: hasattr(x, "spec"))
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf)
         in enumerate(flat)])
    want = {}
    for name, t in moment_model_from_jax(marked).items():
        i = int(t.reshape(-1)[0])
        path, leaf = flat[i]
        spec = tuple(flat_specs[i].spec)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        is_kernel = getattr(path[-1], "key", "") == "kernel"
        want[name] = (None if not dims else
                      (leaf.ndim - 1 - dims[0]) if is_kernel else dims[0])
    got = runs["model:2"][0]["param_shardings"]
    assert got == want
    assert {k for k, d in want.items() if d is not None} == set(
        runs["model:2"][0]["shardings"])
    assert any(d == 1 for d in got.values()) and any(
        d == 0 for d in got.values())


# -- the trainer on a mesh ---------------------------------------------------


@pytest.mark.parametrize("spec", list(SPECS))
def test_steps_with_dropout_equal_one_process(runs, spec):
    """STEPS_A_TASK steps a task with dropout live: each step's loss and
    gradient norm within 1e-6 relative of one process's, the parameters
    after them within 1e-5 of each tensor's largest magnitude, on both
    ranks."""
    want = runs["one"]
    for res in runs[spec]:
        assert [s["task"] for s in res["steps"]] == [
            s["task"] for s in want["steps"]]
        for got, ref in zip(res["steps"], want["steps"]):
            assert _rel(got["loss"], ref["loss"]) <= 1e-6, (got, ref)
            assert _rel(got["norm"], ref["norm"]) <= 1e-6, (got, ref)
        _assert_params_close(res["params"], want["params"], runs["kw"])


def test_padded_final_batch_under_data2(runs):
    """The train split's second moment retrieval batch holds 2 real rows of
    6: rank 0 takes both, rank 1 none (its rows are all padding), and the
    step still equals one process's (above); the dropout mask of the real
    rows is the one-process draw."""
    steps = [r["steps"] for r in runs["data:2"]]
    partial = [i for i, s in enumerate(steps[0]) if s["n_real"] < 6]
    assert [steps[0][i]["task"] for i in partial] == ["moment_retrieval"]
    for i in partial:
        assert steps[0][i]["local_real"] == steps[0][i]["n_real"] == 2
        assert steps[1][i]["local_real"] == 0
        ref = runs["one"]["steps"][i]
        assert _rel(steps[1][i]["loss"], ref["loss"]) <= 1e-6


@pytest.mark.parametrize("spec", ["data:2", "data:2,model:2"])
def test_predictions_equal_one_process(runs, spec):
    """Test and val predictions of every task under the data axis (each
    rank predicts its rows, gathered in batch order): the same JSON as one
    process's, the val losses within 1e-6 relative."""
    want = runs["one"]["predictions"]
    for res in runs[spec]:
        for key, ref in want.items():
            got = dict(res["predictions"][key])
            ref = dict(ref)
            if "loss" in ref:
                assert _rel(got.pop("loss"), ref.pop("loss")) <= 1e-6, key
            assert json.dumps(got) == json.dumps(ref), key


@pytest.mark.parametrize("spec", list(SPECS))
def test_end_to_end_pipeline_equals_one_process(runs, spec):
    """run_end_to_end over the test split under the mesh (its stage
    batches padded, each rank its rows): the same final results as one
    process's, its files written (by rank 0)."""
    want = json.dumps(runs["one"]["end_to_end"])
    for res in runs[spec]:
        assert json.dumps(res["end_to_end"]) == want
    written = {p.name for p in (runs["root"] / _tag(spec)).iterdir()}
    assert "final_end_to_end_results.json" in written


def test_model2_checkpoint_loads_in_one_process_and_resumes(runs):
    """The checkpoint saved under model:2 holds the whole model: one
    process loads it, gets the model:2 run's gathered parameters and
    optimizer state bit for bit, and its next step (dropout live) equals
    the model:2 run's next step at the bars."""
    res = runs["model:2"][0]
    kw = runs["kw"]
    trainer = _trainer(dict(kw, config=dict(kw["config"],
                                            ckpt_dir=str(runs["root"]))))
    # the run's optimizer (its schedule's length), then its state restored
    trainer.setup_optimizer(len(trainer.loaders["train"]["step_captioning"]))
    trainer.load(str(runs["root"] / _tag("model:2") / "MESH.pt"))
    state = trainer.model.state_dict()
    for k, v in res["params"].items():
        assert torch.equal(state[k], v), k
    assert trainer.step == len(res["steps"])
    batch = next(iter(trainer.loaders["train"]["moment_retrieval"]))
    loss, norm = _one_step(trainer, "moment_retrieval", batch)
    assert _rel(loss, res["next"][0]) <= 1e-6
    assert _rel(norm, res["next"][1]) <= 1e-6
    _assert_params_close(_full_params(trainer), res["next_params"], kw)


def test_data2_train_losses_match_jax_data2(tmp_path):
    """Trainer.train() for one epoch under data:2, dropout off: two port
    processes against JAX's Trainer(mesh_shape="data:2") on the 8 virtual
    CPU devices, the same weights: every step's loss within 1e-5
    relative, and the test predictions' JSONs equal."""
    import jax
    from torch_port_util import SERVE_JOINT, hirest_configs, joint_configs

    from hirest_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
    from hirest_tpu.train.trainer import Trainer as JaxTrainer
    from hirest_tpu_torch.models.convert import moment_model_from_jax

    kw = _split_kw(tmp_path, train_batch_size=4, eval_batch_size=2)
    fields = {k: v for k, v in kw["config"].items() if k != "device"}
    fields["frame_buckets"] = tuple(fields["frame_buckets"])
    jax_cfg, _ = hirest_configs(mesh_shape="data:2", **dict(
        fields, ckpt_dir=str(tmp_path / "jax")))
    jt = JaxTrainer(jax_cfg, text_encoder_fn=_text_fn,
                    wordpiece_tokenizer=JaxWordPiece(str(
                        Path(fields["pretrained_dir"]) / "vocab.txt")),
                    verbose=False, model_config=joint_configs(SERVE_JOINT)[0])
    jt.train_model = jt.model  # dropout off
    torch.save(moment_model_from_jax(jax.tree_util.tree_map(
        np.asarray, jt.params)), kw["weights"])
    want_losses = []
    get_step = jt._get_train_step

    def recording(task):
        fn = get_step(task)

        def step(*a):
            out = fn(*a)
            want_losses.append((task, float(out[2])))
            return out
        return step

    jt._get_train_step = recording
    want = jt.train()
    ranks = _spawn(tmp_path, "jax_data2", dict(
        kw, train=True, dropout=False, config=dict(
            kw["config"], mesh_shape="data:2",
            ckpt_dir=str(tmp_path / "port"))))
    for res in ranks:
        got = res["losses"]
        assert [t for t, _ in got] == [t for t, _ in want_losses]
        assert len(got) >= 8
        for (_, a), (_, b) in zip(got, want_losses):
            assert _rel(a, b) <= 1e-5, (a, b)
    for task in TASKS:
        assert json.dumps(ranks[0]["results"][task]) == json.dumps(
            want[task]), task
        assert (tmp_path / "port" / f"test_{task}_BEST.json").exists()


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
