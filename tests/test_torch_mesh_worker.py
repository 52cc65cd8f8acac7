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
count). The cases of ``REMAT`` rematerialise every block under a policy,
recorded by ``remat_probe``. Rank 0
writes each result (the state gathered from the shards) to
``OUT_DIR/<case>.pt``; ``mesh_run`` without a group is the one-process run
they are compared with.
"""

from __future__ import annotations

import contextlib
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
# the cases under remat (models/remat.py): (the case without it, the policy);
# each runs as "<case>-<policy>"
REMAT = [("fsdp2-tensor2", "full"), ("fsdp2-tensor2", "dots"), ("fsdp2-tensor2", "names"),
         ("fsdp2-tensor2", "names_lite"), ("data2-fsdp2", "full"), ("data2-tensor2", "full"),
         ("fsdp4", "full"), ("fsdp2-tensor2-accum2", "full"), ("fsdp2-tensor2-options", "names")]
REMAT_CASES = {f"{base}-{policy}": base for base, policy in REMAT}
CASES.update({f"{base}-{policy}": (CASES[base][0], {**CASES[base][1], "remat": policy})
              for base, policy in REMAT})


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
    model = create_model("edm", remat=options.get("remat"), **MODEL_KW)
    opt = make_optimizer(1e-3, GLOBAL_BATCH, moment_dtype=options.get("moment_dtype"),
                         nu_dtype=options.get("nu_dtype"), fused=options.get("fused", True))
    mesh = sync = None
    if mesh_shape is not None:
        mesh = create_mesh(mesh_shape)
        sync = DataParallel(mesh)
    full = full or {k: v.clone() for k, v in model.state_dict().items()}
    if mesh is not None and mesh.sharded:
        local = create_model("edm", tensor_split=tensor_split_of(mesh),
                             remat=options.get("remat"), **MODEL_KW)
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


@contextlib.contextmanager
def unit_probe(state, events: list | None = None):
    """What a run on the mesh does with its block units in the backward,
    into the dict it yields: ``events``, in order, each unit's gather for
    the backward (``open_for_backward``), its gradient's reduction and its
    release, as (what, unit index, whether the unit was gathered at that
    moment); ``alive``, at each of them (after the gather, before the
    reduction and the release): (what, unit index, the indices of the block
    units whose parameter buffer has storage, those whose gradient buffer
    has, the bytes of each of those two sets, the root's parameter and
    gradient bytes); ``sizes``, each block unit's bytes (of its parameter
    buffer, and of its gradient buffer); ``total``, the bytes of every
    unit's gradient, the whole tensor-local gradient; ``largest``, the
    bytes of the largest gradient buffer."""
    from maskdit_tpu_torch.parallel.sharded import ShardedTrainState

    units = {id(u): i for i, u in enumerate(state.units)}
    out = {"events": [] if events is None else events, "alive": []}
    nbytes = lambda t: t.untyped_storage().nbytes()
    opened, reduce, release = (ShardedTrainState.open_for_backward, ShardedTrainState.reduce,
                               ShardedTrainState.release)

    def gathered(unit) -> bool:
        return unit.gathered and nbytes(unit.full) > 0

    def alive(kind, index):
        params = [i for i, u in enumerate(state.units) if nbytes(u.full)]
        grads = [i for i, u in enumerate(state.units) if nbytes(u.grad)]
        out["alive"].append((kind, index, params, grads,
                             sum(nbytes(state.units[i].full) for i in params),
                             sum(nbytes(state.units[i].grad) for i in grads),
                             nbytes(state.root.full), nbytes(state.root.grad)))

    def logged(kind, fn):
        def run(self, unit):
            index = units.get(id(unit))
            if index is not None:
                out["events"].append((kind, index, gathered(unit)))
                if kind != "gather":
                    alive(kind, index)
            fn(self, unit)
            if index is not None and kind == "gather":
                alive(kind, index)
        return run

    patches = [(ShardedTrainState, "open_for_backward", logged("gather", opened)),
               (ShardedTrainState, "reduce", logged("reduce", reduce)),
               (ShardedTrainState, "release", logged("release", release))]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield out
    finally:
        ShardedTrainState.open_for_backward = opened
        ShardedTrainState.reduce, ShardedTrainState.release = reduce, release
    size = lambda u: u.numel * u.grad.element_size()  # in the dtype the run bound
    out["total"] = sum(size(u) for u in state.all_units)
    out["largest"] = max(size(u) for u in state.all_units)
    out["sizes"] = [size(u) for u in state.units]


@contextlib.contextmanager
def remat_probe(state):
    """What a run on the mesh does around its rematerialised blocks, into
    the dict it yields: ``sums``, the tensor group's fp32 sums
    (``layers._all_reduce_fp32``, forward, backward and recompute);
    ``events``, in order, each backward gather of a block's unit, each
    frame's ``publish`` and its recompute (``replay``, once per frame), and
    each unit's reduction and release (``unit_probe``, whose ``alive``,
    ``sizes``, ``total`` and ``largest`` it also holds), as (what, unit index, whether
    the unit was gathered at that moment); ``keys``, the storage keys the
    frames still held after their forwards;
    ``saved`` and ``equal``, the saved tensors ``unpack`` handed back and
    how many of them equal (values, shape and dtype) what ``pack`` was
    given."""
    from maskdit_tpu_torch.models import layers, remat
    from maskdit_tpu_torch.parallel.sharded import ShardedTrainState

    units = {id(u.module): (i, u) for i, u in enumerate(getattr(state, "units", []))}
    out = {"sums": 0, "events": [], "keys": 0, "saved": 0, "equal": 0}
    reduce = layers._all_reduce_fp32
    Frame = remat._Frame
    forward, publish, replay, pack, unpack = (Frame.forward, Frame.publish, Frame.replay,
                                              Frame.pack, Frame.unpack)

    def gathered(unit) -> bool:
        return unit.gathered and unit.full.untyped_storage().nbytes() > 0

    def counted_reduce(x, split):
        out["sums"] += 1
        return reduce(x, split)

    def logged(kind, fn):
        def run(self, *args):
            if id(self.block) in units and (kind != "replay" or not self.replayed):
                index, unit = units[id(self.block)]
                out["events"].append((kind, index, gathered(unit)))
            return fn(self, *args)
        return run

    def keyed_forward(self, *args):
        y = forward(self, *args)
        out["keys"] += len(self.storages)
        return y

    def kept_pack(self, t):
        return ("probe", t.detach().clone(), pack(self, t))

    def checked_unpack(self, slot):
        _, want, inner = slot
        got = unpack(self, inner)
        out["saved"] += 1
        out["equal"] += int(got.dtype == want.dtype and got.shape == want.shape
                            and torch.equal(got, want))
        return got

    patches = [(layers, "_all_reduce_fp32", counted_reduce),
               (Frame, "forward", keyed_forward), (Frame, "publish", logged("publish", publish)),
               (Frame, "replay", logged("replay", replay)), (Frame, "pack", kept_pack),
               (Frame, "unpack", checked_unpack)]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        if not isinstance(state, ShardedTrainState):  # one process: no units
            yield out
            return
        with unit_probe(state, out["events"]) as record:
            yield out
        out.update({k: record[k] for k in ("alive", "sizes", "total", "largest")})
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)


def mesh_run(mesh_shape: dict | None, options: dict, steps: range = range(STEPS),
             state_and_step=None) -> tuple:
    """Train steps ``steps`` of the tiny model on the global batches, each
    step's draws seeded from (1, step) over the global batch: (``result``,
    the state, the step, the sync). Under remat the result holds
    ``remat_probe``'s record as ``probe``; on a sharded mesh without remat,
    ``unit_probe``'s as ``units``."""
    from maskdit_tpu_torch.parallel.sharded import ShardedTrainState
    from maskdit_tpu_torch.train.trainer import step_seed

    state, step_fn, sync = state_and_step or build(mesh_shape, options)
    generator = torch.Generator()
    metrics = None
    key, probe = None, contextlib.nullcontext()
    if options.get("remat"):
        key, probe = "probe", remat_probe(state)
    elif isinstance(state, ShardedTrainState):
        key, probe = "units", unit_probe(state)
    with probe as record:
        for step in steps:
            generator.manual_seed(step_seed(1, step))
            metrics = step_fn(state, rows(global_batch(step), sync), generator)
    out = result(state, metrics)
    if key is not None:
        out[key] = record
    return out, state, step_fn, sync


def jax_run(mesh_shape: dict | None, inputs: dict, remat=None) -> dict:
    """One step from the JAX test's state, batch and draws (its rows)."""
    from maskdit_tpu_torch.train.state import StepDraws

    state, step_fn, sync = build(mesh_shape, {"mask_ratio": 0.0, "fresh": True,
                                              "remat": remat}, full=inputs["model"])
    state.load({"model": inputs["model"], "ema": inputs["ema"], "opt": inputs["opt"]})
    draws = StepDraws(**inputs["draws"])
    batch = {"x": inputs["x"], "y": inputs["y"]}
    if sync is not None:
        n = batch["x"].shape[0] // sync.world
        sl = slice(sync.rank * n, (sync.rank + 1) * n)
        batch = {k: v[sl] for k, v in batch.items()}
        draws = StepDraws(*(None if d is None else d[sl] for d in draws))
    return result(state, step_fn(state, batch, draws=draws))


def pending_error(mesh_shape: dict) -> str | None:
    """A backward that takes only the root unit's gradients (``inputs=``)
    passes every block without landing its parameters' gradients: the
    micro-batch's end raises (its message, or None)."""
    state, _, sync = build(mesh_shape, {})
    model = state.model
    state.bind(torch.float32, torch.float32)
    state.begin_micro()
    batch = rows(global_batch(0), sync)
    sigma = torch.linspace(0.5, 2.0, batch["x"].shape[0])
    loss = model(batch["x"][:, :CIN], sigma, batch["y"], train=True)["x"].square().mean()
    loss.backward(inputs=state.root.params)
    try:
        state.end_micro(torch.float32)
    except RuntimeError as err:
        return str(err)
    return None


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
        inputs = torch.load(jax_inputs)
        save("jax-fsdp2-tensor2", jax_run({"fsdp": 2, "tensor": 2}, inputs))
        save("jax-fsdp2-tensor2-full", jax_run({"fsdp": 2, "tensor": 2}, inputs, "full"))
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
    save("import-and-nans", {"missing": missing, "nan_errors": everyone,
                             "pending": pending_error({"fsdp": 2, "tensor": 2})})
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
