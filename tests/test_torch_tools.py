"""The tool twins against their JAX originals, on the CPU at tiny dims.

* tools/torch_mu_dtype_curve.py: with ``run`` patched in both tools to
  return the same loss lists, both ``main``s print and write the same report,
  key for key and value for value; the twin itself, 3 steps per variant at
  the ``tiny_dit`` dims (DiT-S/2 rebound to depth 2, width 64, decoder 2 x
  64 x 4): finite losses.
* tools/torch_trace_report.py on a small synthetic Chrome trace: its
  categories (the port's kernels by the launch ranges their launch calls
  lie in; GEMM, elementwise, reduction, copies) and their sums.
* tools/torch_trace_capture.py on the CPU with ``MODEL_TYPE`` patched to
  the tiny DiT-S/2 and PROBE_RES=8, one traced step, read back by the report.
* tools/torch_attn_bench.py: the JAX tool's SHAPES and implementation
  names (read from its source: importing it would point this process's JAX
  compilation cache elsewhere).
* ``flash_mha_batched`` and its gradient against the JAX one on its Pallas
  kernels in interpret mode, fp32 at (1, 2, 128, 16).
"""

import ast
import gzip
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import patch_tiny_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_attn_bench  # noqa: E402
import torch_mu_dtype_curve  # noqa: E402
import torch_trace_capture  # noqa: E402
import torch_trace_report  # noqa: E402

VARIANTS = ["mu", "nu", "munu"]


@pytest.fixture
def two_threads():
    """Torch on 2 threads for the test (the suite runs several workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _load_jax_tool(name: str):
    """tools/<name>.py as a module, with the JAX compilation cache this
    process uses restored after the tool's import points it elsewhere."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax.config.update("jax_compilation_cache_dir", cache)
    return module


@pytest.mark.parametrize("variant", VARIANTS)
def test_mu_curve_report_equals_jax_tools(variant, monkeypatch, tmp_path, capsys):
    jax_tool = _load_jax_tool("mu_dtype_curve")
    assert jax_tool.VARIANTS == torch_mu_dtype_curve.VARIANTS
    rng = np.random.default_rng(3)
    curves = {"fp32": [float(x) for x in rng.uniform(0.5, 1.0, 25)],
              variant: [float(x) for x in rng.uniform(0.5, 1.0, 25)]}

    def fake_run(steps, *, moment_dtype=None, nu_dtype=None, device=None):
        assert steps == 25
        narrow = moment_dtype is not None or nu_dtype is not None
        assert not narrow or {"moment_dtype": moment_dtype, "nu_dtype": nu_dtype} == {
            "moment_dtype": None, "nu_dtype": None, **jax_tool.VARIANTS[variant]}
        return list(curves[variant if narrow else "fp32"])

    outputs = []
    for tool, argv in ((jax_tool, None), (torch_mu_dtype_curve, ["--device", "cpu"])):
        monkeypatch.setattr(tool, "run", fake_run)
        out = str(tmp_path / f"{tool.__name__}.json")
        monkeypatch.setattr(sys, "argv", ["tool", "25", out, variant])
        capsys.readouterr()
        tool.main() if argv is None else tool.main(["25", out, variant, *argv])
        with open(out) as f:
            outputs.append((capsys.readouterr().out, f.read()))
    assert outputs[0] == outputs[1]
    report = json.loads(outputs[0][0])
    assert list(report) == ["variant", "steps", "final_loss_fp32", f"final_loss_{variant}",
                            "tail20_mean_fp32", f"tail20_mean_{variant}", "tail20_gap",
                            "max_step_gap", "mean_step_gap"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_mu_curve_twin_runs_on_cpu(variant, monkeypatch, tmp_path, two_threads):
    patch_tiny_port(monkeypatch)
    out = tmp_path / "curve.json"
    report = torch_mu_dtype_curve.main(["3", str(out), variant, "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert saved["report"] == report and report["variant"] == variant
    for key in ("fp32", variant):
        assert len(saved[key]) == 3 and np.isfinite(saved[key]).all()
    assert report["max_step_gap"] < 0.05 * report["final_loss_fp32"]


def _x(name, ts, dur, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0 if cat == "kernel" else 1,
            "tid": 7 if cat == "kernel" else 2, "ts": ts, "dur": dur, "args": args}


def synthetic_trace() -> dict:
    """Two steps of device events: a GEMM, an elementwise and a reduction
    kernel, a memcpy, kernels #2 and #4 (one kernel name; each launch call,
    a driver and a runtime event, inside its range; a kernel launched just
    after a range, outside it) and #7, and a kernel of none of the
    categories."""
    bwd = "void attention_bwd_mma::(anonymous namespace)::attention_bwd_query_kernel<72>(...)"
    evs = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}}]
    for step in range(2):
        t = 1000 * step
        evs += [
            _x("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", t, 100),
            _x("void at::native::vectorized_elementwise_kernel<4, ...>(...)", t + 100, 30),
            _x("void at::native::reduce_kernel<512, 1, ...>(...)", t + 130, 20),
            _x("Memcpy HtoD (Pageable -> Device)", t + 150, 5, cat="gpu_memcpy"),
            _x("maskdit::packed_attention_bwd", t + 150, 10, cat="user_annotation"),
            _x("cuLaunchKernelEx", t + 152, 2, cat="cuda_driver", correlation=10 + step),
            _x(bwd, t + 160, 40, correlation=10 + step),
            _x("maskdit::packed_attention_big_bwd", t + 300, 10, cat="user_annotation"),
            _x("cudaLaunchKernel", t + 305, 2, cat="cuda_runtime", correlation=20 + step),
            _x(bwd, t + 320, 60, correlation=20 + step),
            _x("cudaLaunchKernel", t + 315, 2, cat="cuda_runtime", correlation=30 + step),
            _x("maskdit::fused_adam_ema", t + 390, 8, cat="user_annotation"),
            _x("cudaLaunchKernel", t + 392, 2, cat="cuda_runtime", correlation=40 + step),
            _x("void (anonymous namespace)::fused_adam_ema_vec4<float, float, float, true>()",
               t + 400, 25, correlation=40 + step),
            _x("void some_library::unnamed_kernel()", t + 430, 3, correlation=30 + step),
        ]
    return {"traceEvents": evs}


def test_trace_report_categories_and_sums(tmp_path, capsys):
    with gzip.open(tmp_path / "old.json.gz", "wt") as f:
        json.dump({"traceEvents": []}, f)
    os.utime(tmp_path / "old.json.gz", (1, 1))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "trace_1.json").write_text(json.dumps(synthetic_trace()))
    out = torch_trace_report.main([str(tmp_path), "2"])
    printed = capsys.readouterr().out
    want = {"GEMM": 0.1, "elementwise": 0.03, "reduction": 0.02,
            "copy / memcpy / memset": 0.005, "#2 packed_attention_bwd": 0.04,
            "#4 packed_attention_big_bwd": 0.06, "#7 fused_adam_ema": 0.025, "other": 0.003}
    assert out["categories"] == pytest.approx(want)
    assert out["ms_per_step"] == pytest.approx(sum(want.values()))
    assert out["events"] == 16
    lines = printed.splitlines()
    assert lines[0].startswith("H100 SXM peaks: 989 TFLOP/s")
    assert lines[1] == "device total: 0.3 ms/step (16 kernel events / 2 steps)"
    for section in ("-- by category --", "-- top kernel families --", "-- top single kernels --"):
        assert section in lines
    assert "    0.10 ms/step  x    1  GEMM" in lines


def test_trace_capture_on_cpu_then_report(monkeypatch, tmp_path, capsys, two_threads):
    patch_tiny_port(monkeypatch)
    monkeypatch.setattr(torch_trace_capture, "MODEL_TYPE", "DiT-S/2")
    env = {"PROBE_RES": "8", "PROBE_BATCH": "4", "N_STEPS": "1"}
    out = torch_trace_capture.main([str(tmp_path), "--device", "cpu"], env=env)
    printed = capsys.readouterr().out
    assert "compile+first: " in printed and "steady state: " in printed
    assert f"trace written to {tmp_path}" in printed and out["runs"] == 1
    path = torch_trace_report.newest_trace(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    report = torch_trace_report.main([str(tmp_path), "1"])  # no device: no kernel events
    assert report == {"ms_per_step": 0.0, "events": 0, "categories": {}}
    with pytest.raises(NotImplementedError, match="PROBE_REMAT=full"):
        torch_trace_capture.main([str(tmp_path), "--device", "cpu"],
                                 env={**env, "PROBE_REMAT": "full"})


def test_attn_bench_shapes_and_impls_equal_jax_tools():
    tree = ast.parse(open(os.path.join(ROOT, "tools", "attn_bench.py")).read())
    shapes = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign) and node.targets[0].id == "SHAPES")
    names = [n.comparators[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Compare) and isinstance(n.left, ast.Name)
             and n.left.id == "name"]
    default = next(ast.literal_eval(n.values[1]) for n in ast.walk(tree)
                   if isinstance(n, ast.BoolOp) and isinstance(n.values[1], ast.List))
    assert torch_attn_bench.SHAPES == shapes
    assert sorted(torch_attn_bench.IMPLS) == sorted(names)
    assert list(torch_attn_bench.IMPLS) == default


def test_attn_bench_rows_on_cpu(capsys):
    rows = torch_attn_bench.bench(list(torch_attn_bench.IMPLS), torch.device("cpu"),
                                  shapes=[("tiny", (1, 2, 128, 16))], iters=1)
    assert [r["impl"] for r in rows] == list(torch_attn_bench.IMPLS)
    assert all(np.isfinite([r["fwd_ms"], r["fwd_bwd_ms"]]).all() for r in rows)
    assert "tiny (1, 2, 128, 16) batched : fwd " in capsys.readouterr().out


def test_flash_mha_batched_matches_jax_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from maskdit_tpu.ops.flash_batched import flash_mha_batched as jax_fmb
    from maskdit_tpu_torch.ops.flash_batched import flash_mha_batched

    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 2, 128, 16)).astype(np.float32) for _ in range(3))
    w = rng.normal(size=(1, 2, 128, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fmb(*map(jnp.asarray, (q, k, v))))
        ref_grads = jax.grad(lambda *a: jnp.sum(jax_fmb(*a) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_mha_batched(qt, kt, vt)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (1, 2, 128, 16)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5)
    for ours, theirs in zip((qt.grad, kt.grad, vt.grad), ref_grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)
