"""Training on the port's mesh: four gloo processes against one process.

One launch of ``python -m torch.distributed.run --nproc_per_node 4 -m
tests.test_torch_mesh_worker`` (the worker imports no jax) trains the tiny
model (``tiny_dit`` dims, fp32) on the meshes {data 2, fsdp 2}, {fsdp 2,
tensor 2}, {data 2, tensor 2} and {fsdp 4}, with ``grad_accum 2`` and with a
bf16 nu, on {data 4} against today's ``DataParallel``, from the JAX step's
injected draws, through a checkpoint saved on {fsdp 2, tensor 2} and
resumed on {data 4}, and through the train CLI's ``--mesh``. This module
compares, in the fp32 training bounds of PERF.md section 2 (loss <= 1e-5,
per-tensor gradient rel-norm <= 1e-4, p / ema / mu / nu <= 1e-5):

  * each mesh's step (the state gathered from the shards) with one
    process's step on the global batch and the same draws;
  * one process's step, and the {fsdp 2, tensor 2} step, with the JAX
    ``state.make_train_step`` from the same parameters, Adam state and
    draws (mask 0: its draws are replicable);
  * ``data = world`` with ``DataParallel`` bit for bit, and the bf16 nu's
    stochastic rounding with the unsharded run's bits;
  * the checkpoint resumed on {data 4} and on one process with the run
    that went on, and the CLI's parse, refusal and one-process resume;
  * remat on the mesh (``worker.REMAT``: {fsdp 2, tensor 2} under each
    policy, 'full' on the other meshes and over two micro-batches, 'names'
    with every step option): bit for bit with the same mesh without remat,
    within the bounds of one process's step under the same policy, and
    under 'full' with the JAX step of ``create_model(remat="full")``; the
    tensor group's sums rerun in the backward under 'full' only; each
    block's unit is gathered for the backward before its frame publishes
    and recomputes, and every saved tensor comes back as it was saved.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.train import state as jax_state
from maskdit_tpu_torch.parallel.mesh import mesh_shape_of, parse_mesh
from maskdit_tpu_torch.train.state import StepDraws, TrainState
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax, state_dict_from_flax
from tests import test_torch_mesh_worker as worker
from tests.test_torch_loss import jax_draws
from tests.test_torch_model import patch_tiny_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "train", "synthetic-smoke.yaml")
# seconds the launch may take before it counts as hung: a guard, not a
# check (~25 s on 8 idle cores)
LAUNCH_TIMEOUT = 600
BOUND = dict(loss=1e-5, grad=1e-4, state=1e-5)
N = worker.GLOBAL_BATCH
STATE_KEYS = ("params", "ema", "mu", "nu")


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def assert_steps_agree(got: dict, want: dict, what: str, nu: bool = True) -> None:
    """The fp32 training bounds: loss, per-tensor gradient and state."""
    loss = abs(float(got["loss"]) / float(want["loss"]) - 1)
    assert loss <= BOUND["loss"], (what, "loss", loss)
    norm = abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1)
    assert norm <= BOUND["loss"], (what, "grad norm", norm)
    grad = max(rel_norm(got["grads"][k], v) for k, v in want["grads"].items())
    assert grad <= BOUND["grad"], (what, "grad", grad)
    for key in STATE_KEYS if nu else STATE_KEYS[:3]:
        err = max(rel_norm(got[key][k], v) for k, v in want[key].items())
        assert err <= BOUND["state"], (what, key, err)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch intra-op thread per test: these tiny dims run hundreds of
    small ops, which a pool of threads per xdist worker only slows."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _jax_start(params, rng):
    ema = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0, 0.01, x.shape))
                       .astype(np.float32), params)
    adam = optax.adam(1e-3).init(params)[0]._replace(
        count=jnp.asarray(4, jnp.int32),
        mu=jax.tree.map(lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32), params),
        nu=jax.tree.map(lambda x: np.abs(rng.normal(0, 1e-5, x.shape)).astype(np.float32),
                        params))
    return ema, adam


def _jax_step(out_dir: str) -> dict:
    """One JAX ``make_train_step`` step at mask 0 from a random state, of
    the model without remat and of ``create_model(remat="full")``; its
    inputs (the state, batch and the step's draws) go to
    ``OUT_DIR/jax_inputs.pt`` for the worker. Returns each result in the
    worker's ``result`` layout, by remat (None, 'full')."""
    kw = {k: v for k, v in worker.MODEL_KW.items() if k not in ("dtype", "use_flash")}
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **kw)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, worker.CIN, worker.RES, worker.RES)), jnp.ones((1,)),
        jnp.zeros((1, worker.K))))["params"]
    rng = np.random.default_rng(70)
    params = jax.tree.map(lambda x: rng.normal(0, 0.05, x.shape).astype(np.float32), shapes)
    ema, adam = _jax_start(params, rng)
    optimizer = jax_state.make_optimizer(1e-3, N, fused=True)
    jstate = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params, ema_params=ema,
                                  opt_state=(adam, *optimizer.init(params)[1:]))
    moments = rng.normal(size=(N, 2 * worker.CIN, worker.RES, worker.RES)).astype(np.float32)
    labels = np.eye(worker.K, dtype=np.float32)[rng.integers(0, worker.K, N)]
    key = jax.random.PRNGKey(71)
    results = {}
    for remat in (None, "full"):
        model = jax_model if remat is None else jax_create_model(
            "edm", dtype=jnp.float32, use_flash=False, remat=remat, **kw)
        step = jax_state.make_train_step(model, optimizer, mask_ratio=0.0, mae_loss_coef=0.1,
                                         ema_decay=0.99)
        new, metrics = step(jstate, {"x": jnp.asarray(moments), "y": jnp.asarray(labels)}, key)
        grads = jax.grad(lambda p, m=model: _jax_loss(m, p, moments, labels, key))(params)
        results[remat] = {
            "loss": torch.tensor(float(metrics["loss"])),
            "grad_norm": torch.tensor(float(metrics["grad_norm"])),
            "grads": state_dict_from_flax(grads), "params": state_dict_from_flax(new.params),
            "ema": state_dict_from_flax(new.ema_params),
            "mu": state_dict_from_flax(new.opt_state[0].mu),
            "nu": state_dict_from_flax(new.opt_state[0].nu)}

    # the step's draws (maskdit_tpu/train/state.py:336-360, loss.py)
    rng_z, rng_drop, rng_loss = jax.random.split(jax.random.fold_in(key, 0), 3)
    shape = (N, worker.CIN, worker.RES, worker.RES)
    sigma, noise = jax_draws(rng_loss, shape)
    t = lambda a: torch.from_numpy(np.array(a))
    torch.save({
        "model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
        "opt": optimizer_state_from_flax(adam), "x": t(moments), "y": t(labels),
        "draws": {"z_noise": t(jax.random.normal(rng_z, shape)),
                  "drop_u": t(jax.random.uniform(rng_drop, (N, 1))),
                  "sigma": t(sigma), "noise": t(noise), "mask_info": None},
    }, os.path.join(out_dir, "jax_inputs.pt"))
    return results


def _jax_loss(jax_model, params, moments, labels, key):
    """The JAX step's loss as a function of the parameters, from its draws
    (its gradient is the step's, for the per-tensor comparison)."""
    from maskdit_tpu.train.loss import EDMLoss
    from maskdit_tpu.train.state import reparameterize_moments

    rng_z, rng_drop, rng_loss = jax.random.split(jax.random.fold_in(key, 0), 3)
    x = reparameterize_moments(rng_z, jnp.asarray(moments))
    y = jnp.asarray(labels) * (jax.random.uniform(rng_drop, (N, 1)) >= 0.1).astype(jnp.float32)

    def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
        return jax_model.apply({"params": params}, xin, sigma, lab, mask_ratio=m_ratio,
                               train=True)

    loss_vec, _ = EDMLoss()(net_apply, x, rng_loss, labels=y, mask_ratio=0.0,
                            mae_loss_coef=0.1, patch_size=2)
    return loss_vec.mean()


def _launch_worker(out_dir: str) -> None:
    """The worker on 4 gloo processes (one thread each)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_addr", "127.0.0.1", "--master_port", str(port),
           "-m", "tests.test_torch_mesh_worker", out_dir]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def launched(tiny_dit_module, tmp_path_factory):
    """The worker's results (OUT_DIR), the JAX step, and the tiny port
    patched in for the one-process runs of this module."""
    out = tmp_path_factory.mktemp("mesh")
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_result = _jax_step(str(out))
    from maskdit_tpu_torch.train.cli import apply_overrides, load_config

    cfg = apply_overrides(load_config(SMOKE), ["log.log_every=1", "log.ckpt_every=3",
                                               "train.fp32=true", "data.length=64",
                                               "train.batchsize=2"])
    with open(out / "smoke.json", "w") as f:
        json.dump(cfg, f)
    _launch_worker(str(out))
    yield out, jax_result
    mp.undo()


@pytest.mark.parametrize("case", ["data2-fsdp2", "fsdp2-tensor2", "data2-tensor2", "fsdp4",
                                  "fsdp2-tensor2-accum2"])
def test_mesh_step_matches_one_process(launched, case):
    """Two steps on the mesh (micro-batches of ``grad_accum`` per rank)
    against one process on the global batch with the same draws."""
    out, _ = launched
    mesh_shape, options = worker.CASES[case]
    got = torch.load(out / f"{case}.pt")
    assert got["count"] == 4 + worker.STEPS
    assert_steps_agree(got, worker.mesh_run(None, options)[0], case)


def test_staged_update_on_the_mesh_matches_one_process(launched):
    """``train.fused_adam: false``: the staged update on the shards."""
    out, _ = launched
    got = torch.load(out / "fsdp2-tensor2-staged.pt")
    assert_steps_agree(got, worker.mesh_run(None, worker.CASES["fsdp2-tensor2-staged"][1])[0],
                       "staged")


def test_every_train_step_option_on_the_mesh(launched):
    """bf16 gradients (the gathered shards rounded once), a bf16
    accumulator over two micro-batches, bf16 mu and nu, the EMA every 2nd
    step: within their own rounding of one process, as the data-parallel
    test bounds them (< 0.5% of the parameters more than 0.05 lr apart;
    the loss within 1e-5)."""
    out, _ = launched
    got = torch.load(out / "fsdp2-tensor2-options.pt")
    want = worker.mesh_run(None, worker.CASES["fsdp2-tensor2-options"][1])[0]
    assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= 1e-5
    flat = lambda d: torch.cat([v.reshape(-1).float() for v in d.values()])
    diff = (flat(got["params"]) - flat(want["params"])).abs()
    assert float((diff > 0.05 * 1e-3).float().mean()) < 0.005
    assert got["nu"]["model.blocks.0.attn.qkv.weight"].dtype == torch.bfloat16


def test_import_and_debug_nans_on_the_mesh(launched):
    """The finetune import grafts onto the shards and names what the file
    lacks; with ``--debug_nans`` a NaN on some ranks' rows raises on every
    rank (the others name no tensor of their own)."""
    out, _ = launched
    got = torch.load(out / "import-and-nans.pt")
    assert got["missing"] == ["model.model.final_layer.linear.bias",
                              "ema.model.final_layer.linear.bias"]
    errors = got["nan_errors"]
    assert all(e is not None and "debug_nans" in e and "train step 0" in e for e in errors)
    assert sum("on another rank" in e for e in errors) == 2


def test_bf16_nu_on_the_mesh_takes_the_unsharded_rounding_bits(launched):
    """nu_dtype bfloat16 on {fsdp 2, tensor 2}: every shard rounds with the
    bits of its elements' unsharded indices, so nu is the one-process nu
    within one bf16 ulp (here: equal) and the rest within the bounds."""
    out, _ = launched
    got = torch.load(out / "fsdp2-tensor2-nu.pt")
    want = worker.mesh_run(None, worker.CASES["fsdp2-tensor2-nu"][1])[0]
    assert_steps_agree(got, want, "nu bf16", nu=False)
    for k, v in want["nu"].items():
        assert got["nu"][k].dtype == v.dtype == torch.bfloat16, k
        ulp = torch.finfo(torch.bfloat16).eps * v.float().abs()
        assert bool(((got["nu"][k].float() - v.float()).abs() <= ulp).all()), k
    same = sum(int(torch.equal(got["nu"][k], v)) for k, v in want["nu"].items())
    assert same == len(want["nu"])


def test_data_world_is_data_parallel_bit_for_bit(launched):
    out, _ = launched
    mesh = torch.load(out / "data4.pt")
    dp = torch.load(out / "data4-dataparallel.pt")
    flat = lambda d: torch.cat([v.reshape(-1).float() for v in d.values()])
    for key in STATE_KEYS:
        assert torch.equal(flat(mesh[key]), dp[key]), key
    assert torch.equal(mesh["loss"], dp["loss"])


def test_one_process_and_mesh_steps_match_the_jax_step(launched):
    """One process's step, with the JAX step's draws, against the JAX
    ``make_train_step``; and the {fsdp 2, tensor 2} step against both."""
    out, jax_results = launched
    jax_result = jax_results[None]
    inputs = torch.load(out / "jax_inputs.pt")
    state, step_fn, _ = worker.build(None, {"mask_ratio": 0.0, "fresh": True},
                                     full=inputs["model"])
    state.load({"model": inputs["model"], "ema": inputs["ema"], "opt": inputs["opt"]})
    one = worker.result(state, step_fn(state, {"x": inputs["x"], "y": inputs["y"]},
                                       draws=StepDraws(**inputs["draws"])))
    assert_steps_agree(one, jax_result, "one process vs JAX")
    mesh = torch.load(out / "jax-fsdp2-tensor2.pt")
    assert_steps_agree(mesh, jax_result, "mesh vs JAX")
    assert_steps_agree(mesh, one, "mesh vs one process")


def test_checkpoint_moves_across_topologies(launched):
    """Saved on {fsdp 2, tensor 2} after two steps: the full layout, which
    resumes on {data 4} and on one process to the step of the run that
    went on."""
    out, _ = launched
    ckpt = torch.load(out / "ckpt.pt")
    state, step_fn, sync = worker.build(None, {})
    assert {k: tuple(v.shape) for k, v in ckpt["model"].items()} == {
        k: tuple(v.shape) for k, v in state.named(state.params).items()}
    assert ckpt["step"] == worker.STEPS and ckpt["opt"]["count"] == 4 + worker.STEPS
    going_on = torch.load(out / "uninterrupted.pt")
    assert_steps_agree(torch.load(out / "resumed-data4.pt"), going_on, "resumed on data 4")
    state.load(ckpt)
    resumed = worker.mesh_run(None, {}, range(worker.STEPS, worker.STEPS + 1),
                              (state, step_fn, sync))[0]
    assert_steps_agree(resumed, going_on, "resumed on one process")


def test_train_cli_mesh_parse_refusal_and_one_process_resume(launched, capsys):
    """``--mesh`` parses as the JAX CLI's; a product other than the process
    count is refused; the {fsdp 2, tensor 2} run writes the full layout,
    which the CLI resumes in one process without a group."""
    out, _ = launched
    assert parse_mesh("data=1,fsdp=2,tensor=2") == {"data": 1, "fsdp": 2, "tensor": 2}
    assert parse_mesh(None) is None
    with pytest.raises(ValueError, match="axis=size"):
        parse_mesh("model=2")
    with pytest.raises(ValueError, match="does not use all 4 processes"):
        mesh_shape_of({"fsdp": 2}, 4)
    report = json.loads((out / "cli.json").read_text())
    assert report["refusal"] == "mesh shape {'data': 3} does not use all 4 processes"
    assert report["step"] == 3 and len(report["losses"]) == 3
    assert all(np.isfinite(report["losses"]))
    from maskdit_tpu_torch.train.cli import main as cli

    got = cli(["--config", str(out / "smoke.json"), "--device", "cpu", "--num_workers", "1",
               "--results_dir", str(out / "cli"), "--max_steps", "1", "train.batchsize=8"])
    assert got["exp_dir"] == report["exp_dir"]
    assert got["step"] == 4 and np.isfinite(got["history"][-1]["loss"])
    assert "resumed from step 3" in capsys.readouterr().out


REMAT_CASES = list(worker.REMAT_CASES)
FSDP2_TENSOR2_POLICIES = {"fsdp2-tensor2": None, "fsdp2-tensor2-full": "full",
                          "fsdp2-tensor2-dots": "dots", "fsdp2-tensor2-names": "names",
                          "fsdp2-tensor2-names_lite": "names_lite"}
BLOCKS = 4  # the tiny model's 2 encoder and 2 decoder blocks: 4 FSDP units


@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_on_the_mesh_equals_no_remat_bit_for_bit(launched, case):
    """Remat on a mesh against the same mesh and options without it: the
    same collectives in the same order, and autograd's own graph (the
    recompute replays the forward's kernels on its shapes), so loss,
    gradient norm and the state gathered from the shards are equal bit for
    bit."""
    out, _ = launched
    got = torch.load(out / f"{case}.pt")
    want = torch.load(out / f"{worker.REMAT_CASES[case]}.pt")
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["grad_norm"],
                                                                  want["grad_norm"])
    for key in ("grads", *STATE_KEYS):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (case, key, k)


@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_on_the_mesh_matches_one_process(launched, case):
    """Each remat case against one process's step under the same policy:
    the fp32 training bounds; with every step option, the options case's
    own bounds (bf16 gradients and moments: the loss within 1e-5, < 0.5% of
    the parameters more than 0.05 lr apart)."""
    out, _ = launched
    got = torch.load(out / f"{case}.pt")
    options = worker.CASES[case][1]
    want = worker.mesh_run(None, options)[0]
    assert got["count"] == want["count"] == 4 + worker.STEPS
    if not options.get("amp_grads"):
        assert_steps_agree(got, want, case)
        return
    assert abs(float(got["loss"]) / float(want["loss"]) - 1) <= 1e-5
    flat = lambda d: torch.cat([v.reshape(-1).float() for v in d.values()])
    diff = (flat(got["params"]) - flat(want["params"])).abs()
    assert float((diff > 0.05 * 1e-3).float().mean()) < 0.005


def test_remat_full_on_the_mesh_matches_the_jax_remat_step(launched):
    """{fsdp 2, tensor 2} under 'full' from the JAX step's state and draws,
    against the JAX ``make_train_step`` of ``create_model(remat="full")``
    and against the same mesh without remat."""
    out, jax_results = launched
    mesh = torch.load(out / "jax-fsdp2-tensor2-full.pt")
    assert_steps_agree(mesh, jax_results["full"], "mesh under full vs JAX under full")
    assert_steps_agree(mesh, torch.load(out / "jax-fsdp2-tensor2.pt"), "full vs none")


def test_tensor_group_sums_rerun_under_full_only(launched):
    """The tensor group's fp32 sums per step on {fsdp 2, tensor 2}: proj's
    and fc2's in the forward and the sums of qkv's and fc1's input
    gradients in the backward, 4 per block; under 'full' the recompute
    reruns proj and fc2 (2 more per block); 'dots', 'names' and
    'names_lite' keep their outputs, so nothing reruns. Over two
    micro-batches, twice as many."""
    out, _ = launched
    sums = {}
    for case in (*FSDP2_TENSOR2_POLICIES, "fsdp2-tensor2-accum2-full"):
        got = torch.load(out / f"{case}.pt")
        if "probe" in got:
            sums[case] = got["probe"]["sums"] / worker.STEPS
    assert sums == {"fsdp2-tensor2-full": 6 * BLOCKS, "fsdp2-tensor2-dots": 4 * BLOCKS,
                    "fsdp2-tensor2-names": 4 * BLOCKS, "fsdp2-tensor2-names_lite": 4 * BLOCKS,
                    "fsdp2-tensor2-accum2-full": 2 * 6 * BLOCKS}
    assert torch.load(out / "data2-fsdp2-full.pt")["probe"]["sums"] == 0


@pytest.mark.parametrize("case", REMAT_CASES)
def test_each_unit_is_gathered_before_its_block_replays(launched, case):
    """The backward order on the mesh: the gradient reaches a block's
    output (``_GatherForBackward``, the unit's hook, after remat's
    ``_Keep``), the unit is gathered again (it was freed after the
    forward), then ``_Keep`` publishes the kept values, then the first
    saved tensor the block dropped is recomputed; block by block from the
    last, once per micro-batch. The frames hold no storage key after their
    forward, and every saved tensor (parameters and their casts, read from
    the gathered buffer; views of kept values; recomputed ones) comes back
    as it was saved."""
    out, _ = launched
    probe = torch.load(out / f"{case}.pt")["probe"]
    micro = worker.STEPS * worker.CASES[case][1].get("grad_accum", 1)
    backward = [(kind, unit, kind != "gather") for unit in reversed(range(BLOCKS))
                for kind in ("gather", "publish", "replay")]
    events = [e for e in probe["events"] if e[0] in ("gather", "publish", "replay")]
    assert events == backward * micro
    assert probe["keys"] == 0
    assert probe["saved"] > 0 and probe["equal"] == probe["saved"]


# every case on a sharded state (data = world runs DataParallel's state)
SHARDED_CASES = [case for case in worker.CASES if case != "data4"]


def _unit_record(case: str, out) -> dict:
    got = torch.load(out / f"{case}.pt")
    return got["probe"] if "probe" in got else got["units"]


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_each_block_is_reduced_and_released_once_per_micro_batch(launched, case):
    """The per-unit gradient (``sharded.reduce`` from the parameters'
    post-accumulate-grad hooks): per micro-batch, block by block from the
    last, the unit is gathered for its backward (under remat its frame then
    publishes and recomputes), then its gradient is reduced and the unit
    released, before the next block's gather; each once per micro-batch."""
    out, _ = launched
    record = _unit_record(case, out)
    options = worker.CASES[case][1]
    micro = worker.STEPS * options.get("grad_accum", 1)
    kinds = ("gather", "publish", "replay") if options.get("remat") else ("gather",)
    backward = [(kind, unit, kind != "gather") for unit in reversed(range(BLOCKS))
                for kind in (*kinds, "reduce", "release")]
    assert record["events"] == backward * micro


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_at_most_two_block_units_are_alive(launched, case):
    """At every gather, reduction and release of a block's unit: at most two
    block units' parameter buffers and two gradient buffers have storage
    besides the root's, within the bytes of the two largest units; no
    gradient buffer, and no set of them alive at once, is as large as the
    whole tensor-local gradient; the state has no whole-gradient buffer."""
    out, _ = launched
    record = _unit_record(case, out)
    two = sum(sorted(record["sizes"])[-2:])
    root = record["total"] - sum(record["sizes"])
    assert record["alive"] and root > 0
    for kind, unit, params, grads, param_bytes, grad_bytes, root_params, root_grads in \
            record["alive"]:
        assert len(params) <= 2 and len(grads) <= 2, (kind, unit, params, grads)
        assert unit in params and unit in grads, (kind, unit, params, grads)
        assert param_bytes <= two and grad_bytes <= two
        assert root_params == root_grads == root
        assert grad_bytes + root_grads < record["total"]
    assert record["largest"] < record["total"]
    from maskdit_tpu_torch.parallel.sharded import ShardedTrainState

    assert not any("grad" in f.name for f in dataclasses.fields(ShardedTrainState)
                   if f.name not in {f.name for f in dataclasses.fields(TrainState)})


def test_a_pending_gradient_at_the_micro_batch_end_raises(launched):
    """A backward that lands no block parameter's gradient (``inputs=`` the
    root's parameters) leaves every block pending: ``end_micro`` raises and
    names each one."""
    out, _ = launched
    message = torch.load(out / "import-and-nans.pt")["pending"]
    assert message is not None and "still pending" in message
    for name in ("model.blocks.0", "model.blocks.1", "model.decoder_blocks.0",
                 "model.decoder_blocks.1"):
        assert name in message, message
