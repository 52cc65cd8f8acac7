"""The exported sampler (``sampling/aot.py``, ``generate --export_aot``) on
the CPU, at the tiny dims in fp32.

The port's file is read back in a fresh process that imports only ``torch``
and ``maskdit_tpu_torch.ops``, and its output equals the live port
sampler's; both are held to the JAX package's exported sampler
(``maskdit_tpu/sampling/aot.py``) on the same weights
(``state_dict_from_flax``), with S_churn 0 and, with JAX's churn noise
passed in, S_churn > 0; the noise helper draws the live sampler's noise.
The bound is the repo's for the port's latents against the JAX sampler's,
1e-5 of max|ref| (tests/test_torch_generate.py ``CLI_REL``): the JAX test's
atol of 1e-5 (tests/test_aot.py:38-40) holds the JAX export to the JAX live
sampler, which computes the same sums; the two packages' fp32 sums differ
in order, and a random model's latents reach ~100-200. Also: the CLI, the registered
ops' fakes at the serving shapes and their launch counters.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from maskdit_tpu.sampling.aot import export_sampler as jax_export_sampler
from maskdit_tpu.sampling.aot import load_sampler as jax_load_sampler
from maskdit_tpu.sampling.generate import SamplerConfig as JaxSamplerConfig
from maskdit_tpu_torch import generate as generate_cli
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big
from maskdit_tpu_torch.ops.exported import load_sampler as exported_load_sampler
from maskdit_tpu_torch.sampling.aot import export_sampler, load_sampler
from maskdit_tpu_torch.sampling.generate import SamplerConfig, make_sample_fn
from tests.test_torch_generate import CLI_REL
from tests.test_torch_masked_model import CIN, K, RES, make_pair
from tests.test_torch_model_corners import assert_rel
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_trainer import ROOT

STEPS, CFG, BATCH = 2, 1.5, 2
BLOCKS = 2 + 2  # the tiny model's encoder and decoder blocks


@pytest.fixture(scope="module")
def exported(tiny_dit_module, tmp_path_factory):
    """The tiny JAX / port pair, its sampler exported by the port to a file,
    and the inputs of one batch."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_model, params, model = make_pair(True, 0.1, seed=60)
    model.eval()
    path = str(tmp_path_factory.mktemp("aot") / "sampler.pt2")
    export_sampler(model, SamplerConfig(num_steps=STEPS, cfg_scale=CFG), BATCH, path)
    rng = np.random.default_rng(61)
    latents = rng.normal(size=(BATCH, CIN, RES, RES)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[[1, 3]]
    yield dict(jax_model=jax_model, params=params, model=model, path=path,
               latents=latents, labels=labels, sample=load_sampler(path))
    mp.undo()


CHURN = 5.0


@pytest.fixture(scope="module")
def cli_exported(exported, tmp_path_factory):
    """``python -m maskdit_tpu_torch.generate --export_aot`` from a reference
    .pt of the same weights, with S_churn > 0, and no VAE to build (the CLI
    builds none: ``load_vae`` fails the test if called)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    tmp = tmp_path_factory.mktemp("cli")
    ckpt, path = str(tmp / "ckpt.pt"), str(tmp / "cli.pt2")
    torch.save({"ema": exported["model"].state_dict()}, ckpt)
    mp.setattr(generate_cli, "load_vae", lambda *a, **k: pytest.fail("VAE built"))
    out = generate_cli.main([
        "--ckpt_path", ckpt, "--export_aot", path, "--model_type", "DiT-S/2",
        "--image_size", str(RES), "--image_channels", str(CIN), "--num_classes", str(K),
        "--use_decoder", "true", "--mae_loss_coef", "0.1", "--fp32", "--num_steps", str(STEPS),
        "--cfg_scale", str(CFG), "--S_churn", str(int(CHURN)), "--max_batch_size", str(BATCH),
        "--device", "cpu"])
    yield dict(out=out, path=path, sample=load_sampler(path))
    mp.undo()


RELOAD = """
import json, sys
import torch
from maskdit_tpu_torch.ops import flash_batched
from maskdit_tpu_torch.ops.exported import load_sampler

inputs, out = sys.argv[1:3]
params, latents, labels = torch.load(inputs)
op = torch.ops.maskdit_torch.packed_attention_fwd.default
report, results = {}, {}
for tag, path in zip(("plain", "churn"), sys.argv[3:]):
    sample = load_sampler(path)
    noise = sample.churn_noise(torch.Generator().manual_seed(7)) if tag == "churn" else None
    results[tag] = sample(params, latents, labels, noise)
    report[tag] = sum(1 for n in sample.program.graph.nodes if n.target is op)
torch.save(results, out)
print(json.dumps({
    "modules": sorted(m for m in sys.modules if m.startswith(("maskdit", "jax"))),
    "op_calls": report,
    "launches": flash_batched.packed_attention.launches,
}))
"""


def test_reload_in_a_fresh_process(exported, cli_exported, tmp_path):
    """The files alone, through ``load_sampler`` in a process that imports
    torch and maskdit_tpu_torch.ops only: no model or sampling module, each
    program calls the registered op once per attention layer and evaluation,
    and its output equals the live port sampler's bit for bit, with S_churn
    0 and (the CLI's file) with S_churn > 0, the churn noise drawn there by
    ``LoadedSampler.churn_noise`` from the generator the live sampler
    takes."""
    model = exported["model"]
    lat, lab = (torch.from_numpy(exported[k]) for k in ("latents", "labels"))
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt")
    torch.save(({k: v.detach() for k, v in model.named_parameters()}, lat, lab), inputs)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", RELOAD, inputs, out, exported["path"],
                           cli_exported["path"]],
                          capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in report["modules"] if m.startswith(("jax", "maskdit_tpu."))]
    assert not [m for m in report["modules"]
                if m.startswith(("maskdit_tpu_torch.models", "maskdit_tpu_torch.sampling"))]
    assert report["op_calls"] == {"plain": (2 * STEPS - 1) * BLOCKS,
                                  "churn": (2 * STEPS - 1) * BLOCKS}
    assert report["launches"] == 0  # the CPU runs the op's plain version
    results = torch.load(out)
    live = make_sample_fn(model, SamplerConfig(num_steps=STEPS, cfg_scale=CFG))(lat, lab)
    assert torch.equal(results["plain"], live)
    live = make_sample_fn(model, SamplerConfig(num_steps=STEPS, cfg_scale=CFG, S_churn=CHURN))(
        lat, lab, torch.Generator().manual_seed(7))
    assert torch.equal(results["churn"], live)


def _jax_churn_noise(key, shape):
    """The JAX sampler's churn noise, step by step (maskdit_tpu/sampling/
    edm.py:104-106), stacked."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(STEPS)])


@pytest.mark.parametrize("churn", [0.0, CHURN], ids=["no-churn", "churn"])
def test_matches_the_jax_exported_sampler(exported, cli_exported, churn):
    """The port's file against the JAX export on the same weights within
    CLI_REL of max|ref|; with S_churn > 0 (the CLI's file) the port takes
    JAX's per-step noise as its churn_noise input, and with
    ``churn_noise(generator)`` it samples what the live sampler samples
    from that generator."""
    model, params = exported["model"], exported["params"]
    lat, lab = exported["latents"], exported["labels"]
    sample = (cli_exported if churn else exported)["sample"]
    assert sample.meta["num_steps"] == STEPS and sample.meta["S_churn"] == churn
    blob = jax_export_sampler(exported["jax_model"], params,
                              JaxSamplerConfig(num_steps=STEPS, cfg_scale=CFG, S_churn=churn),
                              BATCH)
    key = jax.random.PRNGKey(62)
    want = np.asarray(jax_load_sampler(blob)(params, jnp.asarray(lat), jnp.asarray(lab), key))
    tparams = dict(model.named_parameters())
    noise = torch.from_numpy(_jax_churn_noise(key, lat.shape)) if churn else None
    got = sample(tparams, torch.from_numpy(lat), torch.from_numpy(lab), noise)
    assert_rel(got.numpy(), want, CLI_REL, f"S_churn {churn}")
    if churn:
        live = make_sample_fn(model, SamplerConfig(num_steps=STEPS, cfg_scale=CFG,
                                                   S_churn=churn))(
            torch.from_numpy(lat), torch.from_numpy(lab), torch.Generator().manual_seed(7))
        noise = sample.churn_noise(torch.Generator().manual_seed(7))
        assert noise.shape == (STEPS, BATCH, CIN, RES, RES)
        assert torch.equal(sample(tparams, torch.from_numpy(lat), torch.from_numpy(lab), noise),
                           live)
        with pytest.raises(ValueError, match="churn_noise"):
            sample(tparams, torch.from_numpy(lat), torch.from_numpy(lab))


def test_the_file_holds_no_weights(exported):
    """The parameters are an input: the program lifts none of them; the
    file's ``sampler.json`` names them and the export's settings."""
    sample = exported["sample"]
    assert not sample.program.state_dict and sample.program.example_inputs is None
    assert sample.meta["param_names"] == [k for k, _ in exported["model"].named_parameters()]
    assert sample.meta["cfg_scale"] == CFG and sample.meta["device"] == "cpu"
    assert sample.meta["shape"] == [BATCH, CIN, RES, RES]
    assert load_sampler is exported_load_sampler  # one loader, re-exported by sampling.aot


def test_generate_cli_export_aot(cli_exported):
    """``--export_aot`` writes the file it reports, for the batch of
    ``--max_batch_size`` and the sampler flags given, with no --outdir and
    no VAE (``cli_exported``)."""
    out, sample = cli_exported["out"], cli_exported["sample"]
    assert out["path"] == cli_exported["path"]
    assert out["bytes"] == os.path.getsize(out["path"]) > 0
    assert sample.meta["shape"] == [BATCH, CIN, RES, RES]
    assert sample.meta["S_churn"] == CHURN and sample.meta["cfg_scale"] == CFG


def _flags(path: str) -> set:
    with open(path) as f:
        return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))


def test_generate_cli_takes_every_flag_of_the_jax_cli():
    theirs = _flags(os.path.join(ROOT, "generate.py"))
    ours = {a for action in generate_cli.build_parser()._actions for a in action.option_strings}
    assert "--export_aot" in theirs and theirs <= ours, theirs - ours


@pytest.mark.parametrize("op,args,want", [
    # sample256: #1 at the encoder's and decoder's (N, L, 3D) of a CFG batch of 8
    ("packed_attention_fwd", ((16, 256, 3 * 1152), 16), [(16, 256, 1152)]),
    ("packed_attention_fwd", ((16, 256, 3 * 512), 16), [(16, 256, 512)]),
    # sample512: #3 at L 1024, CFG batch 8
    ("packed_attention_big_fwd", ((8, 1024, 3 * 1152), 16), [(8, 1024, 1152)]),
    ("packed_attention_big_fwd", ((8, 1024, 3 * 512), 16), [(8, 1024, 512)]),
    # use_flash: #5 on (N*H, L, hd), o and the fp32 lse
    ("flash_fwd", ((8 * 16, 1024, 72),), [(128, 1024, 72), (128, 1, 1024)]),
    ("flash_fwd", ((16 * 16, 256, 32),), [(256, 256, 32), (256, 1, 256)]),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fakes_give_the_kernels_outputs(op, args, want, dtype):
    """Each op's fake at the serving shapes: the kernel's output shapes, in
    the input's type (the lse in fp32), without computing anything."""
    with FakeTensorMode():
        shape, *rest = args
        if op == "flash_fwd":
            tensors = [torch.empty(shape, dtype=dtype) for _ in range(3)]
            out = getattr(torch.ops.maskdit_torch, op)(*tensors, shape[-1] ** -0.5)
        else:
            x = torch.empty(shape, dtype=dtype)
            out = getattr(torch.ops.maskdit_torch, op)(x, rest[0], 0.1)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in outs] == want
    assert [t.dtype for t in outs] == [dtype, torch.float32][:len(outs)]


@pytest.mark.parametrize("op,fn,plain,counter,inputs", [
    ("packed_attention_fwd", "_launch", "packed_attention_reference", "packed_attention",
     lambda: (torch.randn(2, 16, 3 * 32), 4, 0.25)),
    ("packed_attention_big_fwd", "_launch", "packed_attention_big_reference",
     "packed_attention_big", lambda: (torch.randn(2, 16, 3 * 32), 4, 0.25)),
    ("flash_fwd", "_launch_fwd", "flash_fwd_reference", "flash_fwd",
     lambda: tuple(torch.randn(8, 128, 16) for _ in range(3)) + (0.25,)),
], ids=["#1", "#3", "#5"])
def test_ops_count_their_launches(monkeypatch, op, fn, plain, counter, inputs):
    """Each op's CUDA implementation is its wrapper's launch, which counts one
    launch per call (here with the C launch replaced by the plain version,
    for want of a card), and its CPU implementation the plain version, which
    counts none; the fake matches the CPU implementation (opcheck)."""
    module = {"packed_attention_fwd": flash_batched, "packed_attention_big_fwd": flash_big,
              "flash_fwd": flash}[op]
    op_def = getattr(module, f"{op}_op")
    assert op_def._init_fn is getattr(module, fn)
    wrapper = getattr(module, counter)
    monkeypatch.setattr(wrapper, "launches", 0)
    args = inputs()
    torch.library.opcheck(getattr(torch.ops.maskdit_torch, op).default, args,
                          test_utils=("test_schema", "test_faketensor"))
    got = getattr(torch.ops.maskdit_torch, op)(*args)
    want = getattr(module, plain)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert wrapper.launches == 0
    if op == "flash_fwd":
        monkeypatch.setattr(flash, "_check", lambda name, *t: tuple(t[0].shape))
        monkeypatch.setattr(flash, "_library", lambda: _FakeLibrary())
        monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
    else:
        monkeypatch.setattr(module, "launch", lambda *a, **k: getattr(module, plain)(*a[5:8]))
    for _ in range(3):
        getattr(module, fn)(*args)
    assert wrapper.launches == 3


class _FakeLibrary:
    """The flash forward's C entry with nothing to launch: returns success."""

    @staticmethod
    def flash_fwd(*args):
        return 0
