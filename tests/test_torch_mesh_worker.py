"""One process of the port's mesh tests on the CPU (gloo); imports no jax.

    python -m torch.distributed.run --nproc_per_node 4 -m tests.test_torch_mesh_worker OUT_DIR

Shrinks DiT-S/2 to the tiny dims of the tests (``tiny_dit``: 4 heads,
width 64, a 2 x 64 x 4 decoder) and runs, on 4 processes, the train steps
of ``CASES`` (each a mesh and the step's options) on this process's rows of
a seeded global batch (``mesh_run``), today's ``DataParallel`` step, the
JAX-injected step of ``OUT_DIR/jax_inputs.pt`` where the test wrote one, a
checkpoint saved on {fsdp 2, tensor 2} and resumed on {data 4}, the
non-strict import and ``--debug_nans`` on the mesh, and the train CLI's
``--mesh`` (a run, and its refusal of a product other than the process
count). Rank 0
writes each result (the state gathered from the shards) to
``OUT_DIR/<case>.pt``; ``mesh_run`` without a group is the one-process run
they are compared with.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from tests.test_torch_dist_worker import CIN, GLOBAL_BATCH, K, RES, global_batch, shrink

STEPS = 2
MODEL_KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
                use_decoder=True, mae_loss_coef=0.1, dtype=torch.float32, use_flash=False)
CASES = {
    "data2-fsdp2": ({"data": 2, "fsdp": 2}, {}),
    "fsdp2-tensor2": ({"fsdp": 2, "tensor": 2}, {}),
    "data2-tensor2": ({"data": 2, "tensor": 2}, {}),
    "fsdp4": ({"fsdp": 4}, {}),
    "fsdp2-tensor2-accum2": ({"fsdp": 2, "tensor": 2}, {"grad_accum": 2}),
    "fsdp2-tensor2-nu": ({"fsdp": 2, "tensor": 2}, {"nu_dtype": "bfloat16"}),
    "fsdp2-tensor2-staged": ({"fsdp": 2, "tensor": 2}, {"fused": False}),
    "fsdp2-tensor2-options": ({"fsdp": 2, "tensor": 2}, {
        "grad_accum": 2, "amp_grads": True, "accum_dtype": "bfloat16",
        "moment_dtype": "bfloat16", "nu_dtype": "bfloat16", "ema_every": 2}),
    # against today's DataParallel from its own start (bit for bit)
    "data4": ({"data": 4}, {"fresh": True}),
}


def start_state(full: dict) -> dict:
    """A non-trivial start from the model's parameters: an EMA off them and
    Adam four steps in with moments of the gradients' scale (a fresh Adam's
    first update is lr * sign(g), which amplifies the last bits of the
    near-zero gradients). Seeded per key, the same on every process."""
    g = torch.Generator().manual_seed(7)
    rand = lambda v, s: torch.randn(v.shape, generator=g) * s
    ema = {k: v + rand(v, 0.01) for k, v in full.items()}
    mu = {k: rand(v, 1e-3) for k, v in full.items()}
    nu = {k: rand(v, 1e-5).abs() for k, v in full.items()}
    return {"model": full, "ema": ema, "opt": {"count": 4, "mu": mu, "nu": nu}}


def build(mesh_shape: dict | None, options: dict, full: dict | None = None):
    """The tiny model's train state on the mesh of ``mesh_shape`` (None: one
    process, no mesh) from ``start_state`` of the seed-0 parameters (with
    ``options['fresh']``, the seed-0 model and a fresh Adam), and its train
    step."""
    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.parallel.data_parallel import DataParallel
    from maskdit_tpu_torch.parallel.mesh import create_mesh
    from maskdit_tpu_torch.parallel.sharded import create_sharded_state, tensor_split_of
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step

    torch.manual_seed(0)
    model = create_model("edm", **MODEL_KW)
    opt = make_optimizer(1e-3, GLOBAL_BATCH, moment_dtype=options.get("moment_dtype"),
                         nu_dtype=options.get("nu_dtype"), fused=options.get("fused", True))
    mesh = sync = None
    if mesh_shape is not None:
        mesh = create_mesh(mesh_shape)
        sync = DataParallel(mesh)
    full = full or {k: v.clone() for k, v in model.state_dict().items()}
    if mesh is not None and mesh.sharded:
        local = create_model("edm", tensor_split=tensor_split_of(mesh), **MODEL_KW)
        state = create_sharded_state(local, full, opt, mesh)
    else:
        state = create_train_state(model, opt)
    if not options.get("fresh"):
        state.load(start_state(full))
    step = make_train_step(opt, mask_ratio=options.get("mask_ratio", 0.5), mae_loss_coef=0.1,
                           ema_decay=0.99, grad_accum=options.get("grad_accum", 1),
                           amp_grads=options.get("amp_grads", False),
                           accum_dtype=options.get("accum_dtype"),
                           ema_every=options.get("ema_every", 1),
                           debug_nans=options.get("debug_nans", False), sync=sync)
    return state, step, sync


def rows(batch: dict, sync) -> dict:
    if sync is None:
        return batch
    n = GLOBAL_BATCH // sync.world
    return {k: v[sync.rank * n:(sync.rank + 1) * n] for k, v in batch.items()}


def result(state, metrics) -> dict:
    """The gathered state (collective on the mesh) and the last metrics."""
    out = {k: state.full_named(flat) for k, flat in (
        ("params", state.params), ("ema", state.ema), ("grads", state.grads),
        ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))}
    out["loss"] = metrics["loss"].clone()
    out["grad_norm"] = metrics["grad_norm"].clone()
    out["count"] = state.opt_state.count
    return out


def mesh_run(mesh_shape: dict | None, options: dict, steps: range = range(STEPS),
             state_and_step=None) -> tuple:
    """Train steps ``steps`` of the tiny model on the global batches, each
    step's draws seeded from (1, step) over the global batch: (``result``,
    the state, the step, the sync)."""
    from maskdit_tpu_torch.train.trainer import step_seed

    state, step_fn, sync = state_and_step or build(mesh_shape, options)
    generator = torch.Generator()
    metrics = None
    for step in steps:
        generator.manual_seed(step_seed(1, step))
        metrics = step_fn(state, rows(global_batch(step), sync), generator)
    return result(state, metrics), state, step_fn, sync


def jax_run(mesh_shape: dict | None, inputs: dict) -> dict:
    """One step from the JAX test's state, batch and draws (its rows)."""
    from maskdit_tpu_torch.train.state import StepDraws

    state, step_fn, sync = build(mesh_shape, {"mask_ratio": 0.0, "fresh": True},
                                 full=inputs["model"])
    state.load({"model": inputs["model"], "ema": inputs["ema"], "opt": inputs["opt"]})
    draws = StepDraws(**inputs["draws"])
    batch = {"x": inputs["x"], "y": inputs["y"]}
    if sync is not None:
        n = batch["x"].shape[0] // sync.world
        sl = slice(sync.rank * n, (sync.rank + 1) * n)
        batch = {k: v[sl] for k, v in batch.items()}
        draws = StepDraws(*(None if d is None else d[sl] for d in draws))
    return result(state, step_fn(state, batch, draws=draws))


def main(out_dir: str) -> None:
    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.parallel.data_parallel import data_parallel
    from tests.test_torch_dist_worker import step_run

    shrink()
    dist.init_distributed(device="cpu")
    rank = dist.process_index()
    save = lambda name, obj: rank == 0 and torch.save(obj, os.path.join(out_dir, f"{name}.pt"))
    times = {}
    for name, (shape, options) in CASES.items():
        start = time.time()
        save(name, mesh_run(shape, options)[0])
        times[name] = time.time() - start
    # data = world against today's data-parallel step
    dp = step_run({}, data_parallel())
    save("data4-dataparallel", {k: dp[k] for k in ("params", "ema", "mu", "nu", "loss")})
    jax_inputs = os.path.join(out_dir, "jax_inputs.pt")
    if os.path.exists(jax_inputs):
        save("jax-fsdp2-tensor2", jax_run({"fsdp": 2, "tensor": 2}, torch.load(jax_inputs)))
    # a checkpoint of {fsdp 2, tensor 2} after 2 steps, resumed on {data 4}
    out, state, step_fn, sync = mesh_run({"fsdp": 2, "tensor": 2}, {})
    ckpt = state.checkpoint()
    save("ckpt", ckpt)
    save("uninterrupted", mesh_run(None, {}, range(STEPS, STEPS + 1),
                                   (state, step_fn, sync))[0])
    resumed = build({"data": 4}, {})
    resumed[0].load(ckpt)
    save("resumed-data4", mesh_run(None, {}, range(STEPS, STEPS + 1), resumed)[0])
    # the finetune import on the mesh: non-strict, a key the file lacks named
    state, _, _ = build({"fsdp": 2, "tensor": 2}, {})
    full = state.full_named(state.params)
    lacking = {k: v for k, v in full.items() if k != "model.final_layer.linear.bias"}
    missing = state.load({"model": lacking, "ema": lacking}, strict=False)
    # --debug_nans: NaN rows on the ranks of the second batch block only;
    # every rank raises, naming the step
    state, step_fn, sync = build({"fsdp": 2, "tensor": 2}, {"debug_nans": True})
    batch = rows(global_batch(0), sync)
    if sync.rank == 1:
        batch["x"] = torch.full_like(batch["x"], float("nan"))
    try:
        step_fn(state, batch, torch.Generator().manual_seed(0))
        nan_error = None
    except FloatingPointError as err:
        nan_error = str(err)
    everyone = [None] * dist.process_count()
    torch.distributed.all_gather_object(everyone, nan_error)
    save("import-and-nans", {"missing": missing, "nan_errors": everyone})
    # the CLI: a product other than the world is refused, then a run
    from maskdit_tpu_torch.train.cli import main as cli

    try:
        cli(["--config", os.path.join(out_dir, "smoke.json"), "--device", "cpu",
             "--mesh", "data=3", "--results_dir", os.path.join(out_dir, "refused")])
    except ValueError as err:
        refusal = str(err)
    else:
        refusal = None
    got = cli(["--config", os.path.join(out_dir, "smoke.json"), "--device", "cpu",
               "--num_workers", "1", "--mesh", "data=1,fsdp=2,tensor=2",
               "--results_dir", os.path.join(out_dir, "cli"), "--max_steps", "3"])
    if rank == 0:
        with open(os.path.join(out_dir, "cli.json"), "w") as f:
            json.dump({"refusal": refusal, "step": got["step"], "exp_dir": got["exp_dir"],
                       "losses": [r["loss"] for r in got["history"]], "times": times}, f)
    dist.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
