"""Data-parallel training, sampling and FID of the port on the CPU (gloo).

Two processes under ``python -m torch.distributed.run`` (the worker is
tests/test_torch_dist_worker.py, which imports no jax):

  * the train step of two processes on their halves of a global batch
    equals one process's step on the whole batch (the draws of the global
    batch, one fp32 all-reduce of the gradient), and the two replicas are
    equal bit for bit;
  * the train CLI logs and checkpoints from rank 0 alone, and resumes;
  * the generate CLI writes the images one process writes, ``fid ref``
    writes the statistics of one process, and ``eval_latent`` writes one
    process's images and reaches one FID, from rank-strided seeds and
    images with the statistics summed (compared with one process launched
    alike: the CPU's numerics depend on the thread count).

Also the loader's rank-strided indices against the JAX loader's.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from maskdit_tpu.data.loader import DataLoader as JaxDataLoader
from maskdit_tpu_torch import fid as fid_cli
from maskdit_tpu_torch.data.loader import DataLoader
from maskdit_tpu_torch.data.wds import StreamingWDSLoader, write_wds_shards
from maskdit_tpu_torch.parallel import dist
from maskdit_tpu_torch.utils.png import read_png, write_png
from tests import test_torch_dist_worker as worker
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_vae import write_random_vae

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "train", "synthetic-smoke.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# seconds a launch may take before it counts as hung: a guard, not a check.
# Under six pytest workers on 8 cores the slowest test here took ~114 s
# with its fixture (fid ref: two launches), eval_latent's two launches side
# by side 44 s; one launch of eval_latent, before the FID's sqrtm ran on
# rank 0 alone, passed 120 s there
LAUNCH_TIMEOUT = 600


def _start(*args: str, nproc: int = 2) -> subprocess.Popen:
    """Start the worker under torch.distributed.run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "tests.test_torch_dist_worker", *args]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    """Wait for a started launch; its output (it must exit with 0)."""
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-4000:] + err[-4000:]
    return out


def _launch(*args: str, nproc: int = 2) -> str:
    """Run the worker under torch.distributed.run; its output."""
    return _finish(_start(*args, nproc=nproc))


@pytest.mark.parametrize("options", [
    {}, {"grad_accum": 2},
    {"grad_accum": 2, "amp_grads": True, "accum_dtype": "bfloat16", "moment_dtype": "bfloat16",
     "nu_dtype": "bfloat16", "ema_every": 2},
], ids=["fp32", "fp32-accum2", "options"])
def test_two_processes_step_as_one_process_on_the_global_batch(tmp_path, monkeypatch, options):
    """Equal replicas bit for bit; against one process on the same global
    batch with the same draws: in fp32 within 1e-6 of the parameters'
    scale (the gradient is summed in another order), with the bf16 options
    within their own rounding."""
    _launch("step", str(tmp_path), json.dumps(options))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for key in ranks[0]:
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    patch_tiny_port(monkeypatch)  # the worker's shrink, undone after the test
    one = worker.step_run(options)
    if options.get("amp_grads"):
        # bf16 gradients and a stochastically rounded nu: < 0.5% of the
        # parameters more than 0.05 lr apart (the JAX test's bound for a
        # bf16 accumulator, tests/test_train.py:322-380)
        diff = (ranks[0]["params"] - one["params"]).abs()
        assert float((diff > 0.05 * 1e-3).float().mean()) < 0.005
        torch.testing.assert_close(ranks[0]["loss"], one["loss"], rtol=1e-5, atol=0)
        return
    for key in ("params", "ema", "mu", "nu", "loss"):
        want = one[key]
        torch.testing.assert_close(ranks[0][key], want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()), msg=key)


@pytest.mark.parametrize("options", [
    {"grad_accum": 2},
    {"grad_accum": 2, "amp_grads": True, "accum_dtype": "bfloat16", "moment_dtype": "bfloat16",
     "nu_dtype": "bfloat16", "ema_every": 2},
], ids=["fp32-accum2", "options"])
def test_a_group_of_one_steps_as_no_group_bit_for_bit(tmp_path, options):
    """One process in a group takes the global batch's draws itself
    (``draw_step``) and all-reduces over itself: the steps of a process
    without a group, bit for bit (both launched alike)."""
    _launch("step", str(tmp_path), json.dumps(options), nproc=1)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_dist_worker", "step-alone",
                           str(tmp_path), json.dumps(options)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    group, alone = (torch.load(tmp_path / f) for f in ("rank0.pt", "alone.pt"))
    for key in alone:
        assert torch.equal(group[key], alone[key]), key


def test_process_group_helpers_in_a_group_of_one():
    """``init_distributed`` with an explicit coordinator (the JAX CLI's
    flags), the rank helpers, the host collectives and ``shutdown``; without
    a group each is the one-process identity, and a count above one needs a
    coordinator."""
    assert (dist.process_index(), dist.process_count(), dist.is_main_process()) == (0, 1, True)
    assert dist.all_reduce_mean_scalar(2.5) == 2.5
    with pytest.raises(ValueError, match="--coordinator"):
        dist.init_distributed(num_processes=2)
    assert dist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert not dist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
        assert (dist.process_index(), dist.process_count()) == (0, 1)
        dist.barrier()
        np.testing.assert_array_equal(dist.all_reduce_sum_array(np.arange(3.0)), [0.0, 1.0, 2.0])
        assert dist.all_reduce_mean_scalar(2.5) == 2.5
        assert dist.local_device("cpu") == torch.device("cpu")
        assert dist.local_device("cuda") == torch.device("cuda", 0)
        assert dist.local_device("cuda:3") == torch.device("cuda", 3)
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized()


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle,resample", [(True, False), (False, False), (True, True)])
def test_loader_indices_are_the_jax_loaders(shuffle, resample):
    """Rank r of 2 reads idx[r::2] of the epoch's order, as the JAX loader's
    ``DataLoader(process_index=r, process_count=2)`` (loader.py:55-72)."""
    data = _Indexed(37)
    for rank in (0, 1):
        kw = dict(shuffle=shuffle, seed=3, resample=resample, process_index=rank,
                  process_count=2)
        ours, theirs = DataLoader(data, 4, **kw), JaxDataLoader(data, 4, **kw)
        for epoch in (0, 1):
            np.testing.assert_array_equal(ours.epoch_indices(epoch), theirs.epoch_indices(epoch))
    one = DataLoader(data, 4, seed=3, process_index=0, process_count=1).epoch_indices(0)
    halves = [DataLoader(data, 4, seed=3, process_index=r, process_count=2).epoch_indices(0)
              for r in (0, 1)]
    assert sorted(np.concatenate(halves).tolist()) == sorted(one.tolist())


def test_loader_refuses_a_slice_smaller_than_a_batch():
    """The JAX loader's raise (loader.py:118-131): 7 samples over 2 ranks
    leave rank 1 three, less than a batch of 4."""
    with pytest.raises(ValueError, match="samples/rank/epoch < batch_size 4"):
        next(iter(DataLoader(_Indexed(7), 4, process_index=1, process_count=2)))


def test_loaders_take_rank_and_world_from_the_group(monkeypatch, tmp_path):
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    loader = DataLoader(_Indexed(10), 2)
    assert (loader.rank, loader.world) == (1, 2)
    write_wds_shards([(f"{i:04d}", np.zeros((2, 2, 2), np.float32), 0) for i in range(4)],
                     str(tmp_path), maxcount=2)
    stream = StreamingWDSLoader(str(tmp_path), 2, label_dim=4)
    assert (stream.rank, stream.world) == (1, 2)
    assert DataLoader(_Indexed(10), 2, process_index=0, process_count=1).world == 1


def test_train_cli_two_processes_log_and_save_from_rank_0_and_resume(tmp_path):
    """The global batch is 8 per process x 2 (the name says bs-16); one log
    line per step, from rank 0; rank 0 alone writes log.txt, metrics.jsonl
    and the checkpoints; a second launch resumes on every process."""
    results = str(tmp_path / "results")
    args = ["train", "--config", SMOKE, "--device", "cpu", "--num_workers", "1",
            "--results_dir", results, "log.log_every=1", "log.ckpt_every=2"]
    out = _launch(*args, "--max_steps", "3")
    (name,) = os.listdir(results)
    assert "-bs-16-" in name
    for step in (1, 2, 3):
        assert out.count(f"(step={step:07d}) loss=") == 1, out
    assert out.count("training done at step 3") == 1
    exp = os.path.join(results, name)
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "ckpt_0000002.pt", "ckpt_0000003.pt"]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    assert open(os.path.join(exp, "log.txt")).read().count("(step=0000003)") == 1
    out = _launch(*args, "--max_steps", "2")
    assert out.count("resumed from step 3") == 1 and out.count("(step=0000005) loss=") == 1
    ckpt = torch.load(os.path.join(exp, "checkpoints", "ckpt_0000005.pt"))
    assert ckpt["step"] == 5 and ckpt["opt"]["count"] == 5
    assert all(torch.isfinite(v).all() for v in ckpt["model"].values())


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory):
    """A tiny checkpoint, a full-config random SD-VAE, a folder of PNGs and
    its reference statistics (one process)."""
    root = tmp_path_factory.mktemp("dp_eval")
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    try:
        torch.manual_seed(5)
        model = worker.create_model("edm", img_resolution=worker.RES, img_channels=worker.CIN,
                                    num_classes=worker.K, model_type="DiT-S/2",
                                    use_decoder=True, mae_loss_coef=0.1)
    finally:
        mp.undo()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    ckpt = str(root / "tiny.pt")
    torch.save({"ema": model.state_dict(), "args": {}}, ckpt)
    vae = str(root / "autoencoder_kl.pth")
    write_random_vae(vae)
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(7)
    for i in range(5):
        write_png(str(data / f"{i}.png"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    stats = str(root / "ref.npz")
    # one image per detector batch: the features do not depend on how the
    # processes group the images
    fid_cli.main(["ref", "--data", str(data), "--dest", stats, "--random_detector",
                  "--batch", "1", "--device", "cpu"])
    return dict(root=root, ckpt=ckpt, vae=vae, data=str(data), stats=stats)


def test_fid_ref_two_processes_merge_the_statistics(eval_files, tmp_path):
    """Each process streams its rank-strided images (3 and 2 of 5); the
    summed statistics, which rank 0 writes, are one process's (both
    launched alike: the CPU's numerics depend on its thread count)."""
    dests = [str(tmp_path / f"ref{n}.npz") for n in (1, 2)]
    for n, dest in zip((1, 2), dests):
        _launch("fid", "ref", "--data", eval_files["data"], "--dest", dest,
                "--random_detector", "--batch", "1", "--device", "cpu", nproc=n)
    with np.load(dests[1]) as two, np.load(dests[0]) as one:
        np.testing.assert_allclose(two["mu"], one["mu"], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(two["sigma"], one["sigma"], rtol=1e-10, atol=1e-13)


def _generate_args(files, outdir):
    return ["--ckpt_path", files["ckpt"], "--outdir", outdir, "--seeds", "0-3",
            "--max_batch_size", "1", "--cfg_scale", "1.5", "--num_steps", "2", "--fp32",
            "--device", "cpu", "--model_type", "DiT-S/2", "--image_size", str(worker.RES),
            "--num_classes", str(worker.K), "--use_decoder", "True", "--mae_loss_coef", "0.1",
            "--pretrained_path", files["vae"]]


def _same_pngs(a: str, b: str, n: int) -> None:
    assert sorted(p for p in os.listdir(a) if p.endswith(".png")) == [
        f"{s:06d}.png" for s in range(n)]
    for s in range(n):
        np.testing.assert_array_equal(read_png(os.path.join(a, f"{s:06d}.png")),
                                      read_png(os.path.join(b, f"{s:06d}.png")))


def test_generate_two_processes_write_the_images_of_one(eval_files, tmp_path):
    """Rank r samples the seed batches r, r + 2, ...; every seed's PNG is the
    one a single process writes; rank 0 alone prints and writes log.txt."""
    outs = {n: str(tmp_path / f"procs{n}") for n in (1, 2)}
    for n, outdir in outs.items():
        out = _launch("generate", *_generate_args(eval_files, outdir), nproc=n)
        assert out.count("Done: 4 images") == 1
        assert f"{n} process" in out
    _same_pngs(outs[2], outs[1], 4)
    assert sorted(os.listdir(outs[2])) == sorted(os.listdir(outs[1]))  # one log.txt


def test_eval_latent_two_processes(eval_files, tmp_path):
    """Rank-strided seeds, a barrier, then one FID of the merged statistics
    (printed once, by rank 0); the PNGs are one process's. The two launches
    run side by side."""
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "model": {"precond": "edm", "model_type": "DiT-S/2", "in_size": worker.RES,
                  "in_channels": worker.CIN, "num_classes": worker.K, "use_decoder": True,
                  "ext_feature_dim": 0, "pad_cls_token": False, "mae_loss_coef": 0.1},
        "eval": {"batchsize": 4, "ref_path": eval_files["stats"]},
    }))

    def args(outdir):
        return ["--config", str(config), "--ckpt_path", eval_files["ckpt"], "--outdir", outdir,
                "--seeds", "0-3", "--cfg_scale", "1.5", "--num_steps", "2",
                "--max_batch_size", "1", "--num_expected", "4", "--fid_batch_size", "1",
                "--pretrained_path", eval_files["vae"], "--random_detector", "--device", "cpu"]

    two = _start("eval_latent", *args(str(tmp_path / "two")))
    one = _start("eval_latent", *args(str(tmp_path / "one")), "--skip_fid", nproc=1)
    out = _finish(two)
    _finish(one)
    (value,) = re.findall(r"FID: ([-\d.e+]+)", out)
    assert np.isfinite(float(value))
    pngs = "edm-steps2-cfg1.5"
    _same_pngs(str(tmp_path / "two" / pngs), str(tmp_path / "one" / pngs), 4)
