"""Training: the port's train step on seeded moments, labels and draws.

Set-up builds one ``train.state.create_train_state`` state over a
``models.create_model`` model loaded with seeded weights, and one
``train.state.make_train_step`` step as the trainer builds it. It drives
that step through its first ``CHECKED`` steps (their losses, the first
gradient's norm per leaf as Adam holds it, and each leaf's change of the
parameters and of the EMA after the last are kept), which also warm up
every shape, and hands the same state and step to the window: the checked
steps are the last before the window opens, through the window's own call.
Every step gets a new batch and new draws (``StepDraws``) from the seed,
made on the card.

The window runs steps back to back and closes at a synchronize after the
step during which ``seconds`` passed on the host clock: images/s is every
step's images over that wall time; each step's time comes from CUDA events
recorded at the step boundaries and read after the window.

``check`` runs ``portbench/reference/train.py`` over the same first steps
from the same weights, in fp32 without TF32, and compares.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import counts, harness
from portbench.trace import feed_range
from portbench.weights import DTYPES, load_weights
from portbench.reference import maskdit as ref_model
from portbench.reference import train as ref_train
from portbench.reference.fp8 import Fp8Ops

CHECKED = 3
# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone: left out of the change comparisons
NEGLIGIBLE_GRAD = 1e-3


class Run:
    profile_units = 3

    def __init__(self, ctx: harness.Ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        cfg = self.cfg
        self.n = self.mix["batch"]
        self.grid = cfg["in_size"] // cfg["patch_size"]
        self.tokens = self.grid * self.grid
        self.keep = int(self.tokens * (1.0 - self.mix["mask_ratio"]))
        self.spec = ref_model.param_spec(cfg)
        self.next_step = 0

    # -- the seeded inputs ------------------------------------------------

    def feed(self, k: int) -> dict:
        """Step ``k``'s moments, labels and draws, made on the card."""
        cfg, mix, n, dev = self.cfg, self.mix, self.n, self.ctx.device
        g = self.ctx.generator(f"feed{k}")
        c, hw = cfg["in_channels"], cfg["in_size"]
        with feed_range():
            lo, hi = mix["latent_logvar_range"]
            mean = torch.randn((n, c, hw, hw), generator=g, device=dev) * mix["latent_mean_std"]
            logvar = torch.rand((n, c, hw, hw), generator=g, device=dev) * (hi - lo) + lo
            classes = torch.randint(0, cfg["num_classes"], (n,), generator=g, device=dev)
            u = torch.rand((n, self.tokens), generator=g, device=dev)
            ids_shuffle = torch.argsort(u, dim=1)
            ids_restore = torch.argsort(ids_shuffle, dim=1)
            return {
                "moments": torch.cat([mean, logvar], dim=1),
                "labels": torch.nn.functional.one_hot(classes, cfg["num_classes"]).float(),
                "z_noise": torch.randn((n, c, hw, hw), generator=g, device=dev),
                "drop_u": torch.rand((n, 1), generator=g, device=dev),
                "sigma": torch.exp(torch.randn((n,), generator=g, device=dev) * cfg["P_std"]
                                   + cfg["P_mean"]),
                "noise": torch.randn((n, c, hw, hw), generator=g, device=dev),
                "ids_keep": ids_shuffle[:, :self.keep],
                "ids_restore": ids_restore,
                "mask": (ids_restore >= self.keep).float(),
            }

    def _program_inputs(self, f: dict):
        from maskdit_tpu_torch.models.masking import MaskInfo
        from maskdit_tpu_torch.train.state import StepDraws

        draws = StepDraws(f["z_noise"], f["drop_u"], f["sigma"], f["noise"],
                          MaskInfo(f["mask"], f["ids_keep"], f["ids_restore"], None))
        return {"x": f["moments"], "y": f["labels"]}, draws

    # -- the program --------------------------------------------------------

    def build_program(self):
        from maskdit_tpu_torch.models import create_model
        from maskdit_tpu_torch.train.loss import EDMLoss
        from maskdit_tpu_torch.train.state import (create_train_state, make_optimizer,
                                                   make_train_step)

        cfg, mix, dev = self.cfg, self.mix, self.ctx.device
        with dev:
            model = create_model(
                cfg["precond"], img_resolution=cfg["in_size"], img_channels=cfg["in_channels"],
                num_classes=cfg["num_classes"], sigma_data=cfg["sigma_data"],
                model_type=cfg["model_type"], use_decoder=cfg["use_decoder"],
                mae_loss_coef=cfg["mae_loss_coef"], dtype=DTYPES[cfg["compute_dtype"]],
            ).to(dev)  # the sin-cos tables are made on the host
        self.ctx.mark("model")
        load_weights(model, self.spec, self.ctx.subseed("weights"), dev)
        self.ctx.mark("weights")
        opt = make_optimizer(mix["lr"], global_batch_size=self.n, rampup_kimg=0.0,
                             betas=(mix["adam_b1"], mix["adam_b2"]), eps=mix["adam_eps"])
        self.state = create_train_state(model, opt)
        self.step = make_train_step(
            opt, loss_fn=EDMLoss(cfg["P_mean"], cfg["P_std"], cfg["sigma_data"]),
            mask_ratio=mix["mask_ratio"], mae_loss_coef=cfg["mae_loss_coef"],
            class_dropout_prob=cfg["class_dropout_prob"], ema_decay=mix["ema_decay"],
            grad_accum=mix["grad_accum"], scale_factor=cfg["scale_factor"],
            ema_every=mix["ema_every"],
        )

    def units(self, count: int) -> list:
        """Run ``count`` steps on the next feeds; returns their metrics."""
        out = []
        for _ in range(count):
            batch, draws = self._program_inputs(self.feed(self.next_step))
            out.append(self.step(self.state, batch, draws=draws))
            self.next_step += 1
        return out

    def setup(self) -> None:
        self.build_program()
        self.ctx.mark("program")
        state = self.state
        losses = []
        for k in range(CHECKED):
            losses.append(self.units(1)[0]["loss"])
            if k == 0:  # Adam's first moment after one step is (1 - b1) g
                mu = state.named(state.opt_state.mu)
                norms = ref_train.leaf_norms(mu.values())
                self.grad_norms = {k: v / (1.0 - self.mix["adam_b1"])
                                   for k, v in zip(mu, norms)}
                self.ctx.mark("first_step")
        self.losses = [float(x) for x in losses]
        self.ctx.mark("checked_steps")
        p0 = ref_model.make_params(self.spec, self.ctx.subseed("weights"), self.ctx.device)
        with torch.no_grad():
            params, ema = state.named(state.params), state.named(state.ema)
            self.change_norms = dict(zip(params, ref_train.leaf_norms(
                params[k] - p0[k] for k in params)))
            self.ema_change_norms = dict(zip(ema, ref_train.leaf_norms(
                ema[k] - p0[k] for k in ema)))
        del p0

    def window(self, seconds: float) -> dict:
        clock = _StepClock(self.ctx.device)
        t0 = time.perf_counter()
        steps = 0
        while True:
            self.units(1)
            clock.mark()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        clock.sync()
        wall = time.perf_counter() - t0
        step_ms = clock.intervals_ms()
        return {
            "metrics": {
                "train_images_per_s": steps * self.n / wall,
                "train_step_ms_p90": float(np.percentile(step_ms, 90)),
            },
            "attempted": steps,
        }

    def layout(self) -> dict:
        cfg = self.cfg
        d, dd = cfg["hidden_size"], cfg["decoder_hidden_size"]
        h, hdec = cfg["num_heads"], cfg["decoder_num_heads"]
        return {
            "evals_per_unit": 1,
            "images_per_unit": self.n,
            "flops_per_image": counts.train_flops_per_image(cfg, self.mix["mask_ratio"]),
            "elem_bytes": DTYPES[cfg["compute_dtype"]].itemsize,
            "attention": [(self.n, self.keep, h, d // h, cfg["depth"]),
                          (self.n, self.tokens, hdec, dd // hdec, cfg["decoder_depth"])],
            "adam_elements": sum(int(np.prod(s)) for _, s in self.spec),
            "adam_bytes_per_element": counts.adam_bytes_per_element(),
        }

    def release(self) -> None:
        self.state = self.step = None
        harness.free_device_memory()

    # -- the comparison ----------------------------------------------------

    def reference(self, ops=None) -> dict:
        """The reference's (or, given ``ops``, the control's) readings over
        the checked steps' feeds."""
        mix = self.mix
        feeds = [self.feed(k) for k in range(CHECKED)]
        opt = {"b1": mix["adam_b1"], "b2": mix["adam_b2"], "eps": mix["adam_eps"],
               "lr": mix["lr"], "ema_decay": mix["ema_decay"]}
        with ref_model.exact_fp32():
            p0 = ref_model.make_params(self.spec, self.ctx.subseed("weights"), self.ctx.device)
            out = ref_train.run_steps(p0, self.cfg, opt, feeds, ops or ref_model.Fp32Ops(),
                                      mix["reference_rows"])
        del p0, feeds
        harness.free_device_memory()
        return out

    def check(self) -> dict:
        program = {"losses": self.losses, "grad_norms": self.grad_norms,
                   "change_norms": self.change_norms, "ema_change_norms": self.ema_change_norms}
        return compare(program, self.reference())

    def control(self) -> dict:
        """The control's readings: the reference in fp8 in the program's place."""
        return compare(self.reference(Fp8Ops()), self.reference())


def compare(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` compares: the worst step's relative loss gap,
    and by the worst leaf the gap of the first gradient's norm and of the
    parameters' and the EMA's change over the checked steps."""
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    moving = [k for k, v in grads.items() if v >= NEGLIGIBLE_GRAD * median]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": worst_leaf_gap(prog["grad_norms"], grads),
        "update_norm_gap": worst_leaf_gap(prog["change_norms"], ref["change_norms"], moving),
        "ema_update_norm_gap": worst_leaf_gap(prog["ema_change_norms"], ref["ema_change_norms"],
                                              moving),
    }


def worst_leaf_gap(program: dict, reference: dict, leaves=None) -> float:
    """max over leaves of |program - reference| / max(reference, median
    reference): the gap of a per-leaf norm, against the leaf's own norm or
    the median leaf's, whichever is larger."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = float(np.median([reference[k] for k in leaves]))
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in leaves)


class _StepClock:
    """Step boundaries: CUDA events on the current stream (read after the
    window, so nothing waits inside it), or the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def intervals_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]
