"""The port's mesh in two checkouts, in one call: memory, parity and ms/step.

    python3 tools/torch_mesh_ab.py BEFORE_DIR AFTER_DIR [--cases A,B] [--depths 2,4]
        [--steps N]

Each directory is the root of a checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a gitignored
directory, and the working tree). Four turns run in the order before,
after, after, before, each a launch of 4 gloo ranks sharing one NVIDIA GPU
(``python -m torch.distributed.run``, ``--device cuda:0``) from that
checkout's root, so every number is that commit's code:

  * each ``chip_smoke.MESH_PARITY`` case of ``--cases`` (default
    fsdp2-tensor2, fsdp2-tensor2-full, data2-fsdp2; a case of
    ``MESH_SAME_AS`` after its base) at each encoder depth of ``--depths``
    (default 2; DiT-XL/2 at full width), through the checkout's
    ``chip_smoke.mesh_case``: one fp32 step against one process's, its
    errors, and per rank above the step's start the peak, the memory at
    the backward's first gather and at its end (and, where the checkout's
    mesh_case reads them, the units' buffers alive at once, their bound and
    the per-unit staging);
  * then, with ``--steps`` N > 0 (default 10), the train CLI with ``--mesh
    data=1,fsdp=2,tensor=2`` on ``chip_smoke.TRAIN_CONFIG`` with synthetic
    latents in place of the LMDB, at ``chip_smoke.DDP_DEPTH`` encoder
    blocks, a batch of ``MESH_TRAIN_BATCH`` rows per rank, logging every
    step and writing no checkpoint: ms per step of steps 2-N and their
    median.

One ``[mesh-ab]`` line per case and per train run, then the medians of the
train runs per checkout; the last line is the card's name and power limit.
Needs CUDA; each checkout's kernels are built first, under its own
build/kernels (``chip_smoke.phase_build``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

CASES = "fsdp2-tensor2,fsdp2-tensor2-full,data2-fsdp2"


def worker(root: str, out_path: str, depths: str, cases: str, steps: int) -> None:
    """One rank of a turn, from ``root``: the cases, then the train CLI."""
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import torch.distributed as tdist

    import chip_smoke as smoke
    from maskdit_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_distributed(backend="gloo", device="cuda:0")
    torch.cuda.set_device(0)
    os.makedirs(smoke.SCRATCH, exist_ok=True)
    by_name = {c[0]: c for c in smoke.MESH_PARITY}
    result = {"root": root, "parity": {}}
    for depth in (int(d) for d in depths.split(",")):
        held = {}
        with smoke.xl_depth(depth):
            for name in filter(None, cases.split(",")):
                t0 = time.perf_counter()
                got = smoke.mesh_case(by_name[name], held)
                keys = [k for k, v in got.items() if isinstance(v, (int, float, dict))]
                everyone = [None] * dist.process_count()
                tdist.all_gather_object(everyone, {k: got[k] for k in keys})
                result["parity"][f"{name}@{depth}"] = everyone
                if dist.is_main_process():
                    r0 = everyone[0]
                    gib = lambda k: [round(e[k] / 2**30, 3) for e in everyone if k in e]
                    print(f"[mesh-ab] {root} {name} depth {depth}: loss {r0['loss']:.3e} grad "
                          f"{r0['grad']:.3e} state {r0['state']:.3e} same_as "
                          f"{r0.get('same_as')}; peak {gib('peak')} GiB, to the reduction "
                          f"{gib('peak_to_reduction')}, backward start {gib('backward_start')},"
                          f" end {gib('backward_end')}, units alive {gib('units_alive')}, "
                          f"bound {gib('units_bound')}, staging {gib('staging')}; ms "
                          f"{[round(e['ms'], 1) for e in everyone]}; "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
                tdist.barrier()
    if steps:
        from maskdit_tpu_torch.train import main as train_main

        config = json.loads(json.dumps(smoke.TRAIN_CONFIG))
        config["data"] = {"dataset": "synthetic", "category": "synthetic", "resolution": 32,
                          "num_channels": 4, "length": 4096}
        path = os.path.join(smoke.SCRATCH, "mesh-ab-config.json")
        results = os.path.join(smoke.SCRATCH, "mesh-ab")
        if dist.is_main_process():
            import shutil

            shutil.rmtree(results, ignore_errors=True)
            with open(path, "w") as f:
                json.dump(config, f)
        dist.barrier()
        with smoke.xl_depth(smoke.DDP_DEPTH), contextlib.redirect_stdout(io.StringIO()):
            run = train_main(["--config", path, "--results_dir", results, "--device", "cuda:0",
                              "--dist_backend", "gloo", "--num_workers", "2", "--mesh",
                              smoke.MESH_TRAIN, f"train.batchsize={smoke.MESH_TRAIN_BATCH}",
                              f"train.max_num_steps={steps}", "log.log_every=1",
                              "log.ckpt_every=1000000"])
        ms = [1e3 / r["steps_per_sec"] for r in run["history"][1:]]
        result["train_ms"] = ms
        if dist.is_main_process():
            print(f"[mesh-ab] {root} train-mesh (synthetic latents) ms/step after the first: "
                  f"{[round(x, 1) for x in ms]}, median {statistics.median(ms):.1f}; peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (rank 0)", flush=True)
    if dist.is_main_process():
        with open(out_path, "w") as f:
            json.dump(result, f)
    dist.shutdown()


def turn(root: str, args) -> dict:
    """One launch of 4 ranks from ``root``; its rank 0's result."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
             "--master_addr", "127.0.0.1", "--master_port", str(port),
             os.path.abspath(__file__), "--worker", root, out, args.depths, args.cases,
             str(args.steps)], capture_output=True, text=True, timeout=900)
        print("".join(line + "\n" for line in proc.stdout.splitlines()
                      if line.startswith("[mesh-ab]")), end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"torch_mesh_ab: the turn in {root} failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
        with open(out) as f:
            return json.load(f)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        root, out, depths, cases, steps = argv[1:]
        worker(root, out, depths, cases, int(steps))
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("before")
    parser.add_argument("after")
    parser.add_argument("--cases", default=CASES)
    parser.add_argument("--depths", default="2")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    before, after = os.path.abspath(args.before), os.path.abspath(args.after)
    runs = {before: [], after: []}
    for root in runs:  # each checkout's kernels, once, before its ranks need them
        build = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.phase_build()"], cwd=root,
            capture_output=True, text=True)
        if build.returncode != 0:
            raise SystemExit(f"torch_mesh_ab: the kernels of {root} did not build:\n"
                             f"{build.stdout[-2000:]}{build.stderr[-2000:]}")
    for root in (before, after, after, before):
        runs[root].append(turn(root, args))
    for root, results in runs.items():
        medians = [statistics.median(r["train_ms"]) for r in results if r.get("train_ms")]
        print(f"[mesh-ab] {root}: train-mesh median ms/step per turn "
              f"{[round(m, 1) for m in medians]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
