"""Sampling: the port's EDM Heun sampler with classifier-free guidance.

Set-up builds ``models.create_model`` loaded with seeded weights and the
sampler ``sampling.generate.make_sample_fn`` as the generate CLI does (no
churn), and warms up every shape with a two-step run of the same batch.
The window samples whole batches of seeded latents and labels, made on
the card, each ending in a synchronize, until ``seconds`` have passed:
images/s is the images of those batches over the seconds they took.

A forward hook keeps, for every batch, the program's denoiser input and
output at the first evaluation of each Heun step in ``denoise_steps`` (a
copy on the card, three of 79 evaluations).

``check`` draws ``compare_images`` of the window's images from the seed and
samples them again with ``portbench/reference/sample.py`` in fp32 without
TF32: ``sample_gap`` is the worst image's norm of the difference of the
two final latents over the norm of the reference's. ``denoise_gap`` is the
same of the denoiser's output at the kept evaluations, the reference's
denoiser run at the program's own inputs there: one evaluation, before
forty steps of the program's bf16 activations blur what its products do.
"""

from __future__ import annotations

import time

import torch

from portbench import counts, harness
from portbench.reference import maskdit as ref_model
from portbench.reference import sample as ref_sample
from portbench.reference.fp8 import Fp8Ops
from portbench.trace import feed_range
from portbench.weights import DTYPES, load_weights


class Run:
    profile_units = 1

    def __init__(self, ctx: harness.Ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.n = self.mix["batch"]
        self.spec = ref_model.param_spec(self.cfg)
        self.next_batch = 0
        self.done = []  # (latents, labels, sampled) of the window's batches

    def feed(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Batch ``b``'s latents and one-hot labels, made on the card."""
        cfg, dev = self.cfg, self.ctx.device
        g = self.ctx.generator(f"batch{b}")
        hw = cfg["in_size"]
        with feed_range():
            latents = torch.randn((self.n, cfg["in_channels"], hw, hw), generator=g, device=dev)
            classes = torch.randint(0, cfg["num_classes"], (self.n,), generator=g, device=dev)
            return latents, torch.nn.functional.one_hot(classes, cfg["num_classes"]).float()

    def _sampler(self, num_steps: int):
        from maskdit_tpu_torch.sampling.generate import SamplerConfig, make_sample_fn

        mix = self.mix
        extra = {"sigma_min": mix["sigma_min"], "sigma_max": mix["sigma_max"], "rho": mix["rho"]}
        return make_sample_fn(self.model, SamplerConfig(
            num_steps=num_steps, cfg_scale=mix["cfg_scale"], S_churn=0.0, extra=extra))

    def setup(self) -> None:
        from maskdit_tpu_torch.models import create_model

        cfg, dev = self.cfg, self.ctx.device
        with dev:
            self.model = create_model(
                cfg["precond"], img_resolution=cfg["in_size"], img_channels=cfg["in_channels"],
                num_classes=cfg["num_classes"], sigma_data=cfg["sigma_data"],
                model_type=cfg["model_type"], use_decoder=cfg["use_decoder"],
                mae_loss_coef=cfg["mae_loss_coef"], dtype=DTYPES[cfg["compute_dtype"]],
            ).to(dev)  # the sin-cos tables are made on the host
        self.model.eval()
        self.ctx.mark("model")
        load_weights(self.model, self.spec, self.ctx.subseed("weights"), dev)
        self.ctx.mark("weights")
        self.sample = self._sampler(self.mix["num_steps"])
        latents, labels = self.feed(-1)
        self._sampler(2)(latents, labels)  # every shape of the window
        # the first evaluation of each Heun step i is evaluation 2i
        self.kept_evals = {2 * i for i in self.mix["denoise_steps"]}
        self.model.register_forward_hook(self._keep, with_kwargs=True)

    def _keep(self, module, args, kwargs, output) -> None:
        """The program's denoiser input and output at the kept evaluations
        of the current batch (a copy on the card: nothing waits)."""
        if self.evals in self.kept_evals:
            x, sigma = args[0], args[1]
            self.kept[self.evals] = (x.detach().clone(), sigma.detach().clone(),
                                     output["x"].detach().clone())
        self.evals += 1

    def units(self, count: int) -> None:
        """Sample ``count`` more batches, each ending in a synchronize."""
        for _ in range(count):
            latents, labels = self.feed(self.next_batch)
            self.evals, self.kept = 0, {}
            out = self.sample(latents, labels)
            if self.ctx.device.type == "cuda":
                torch.cuda.synchronize()
            self.done.append((latents, labels, out, self.kept))
            self.next_batch += 1

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.units(1)
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        images = len(self.done) * self.n
        return {"metrics": {"sample_images_per_s": images / wall}, "attempted": images}

    def layout(self) -> dict:
        cfg = self.cfg
        tokens = (cfg["in_size"] // cfg["patch_size"]) ** 2
        rows = self.n * (2 if self.mix["cfg_scale"] != 1.0 else 1)
        d, dd = cfg["hidden_size"], cfg["decoder_hidden_size"]
        h, hdec = cfg["num_heads"], cfg["decoder_num_heads"]
        return {
            "evals_per_unit": 2 * self.mix["num_steps"] - 1,
            "images_per_unit": self.n,
            "flops_per_image": counts.sample_flops_per_image(
                cfg, self.mix["num_steps"], self.mix["cfg_scale"]),
            "elem_bytes": DTYPES[cfg["compute_dtype"]].itemsize,
            "attention": [(rows, tokens, h, d // h, cfg["depth"]),
                          (rows, tokens, hdec, dd // hdec, cfg["decoder_depth"])],
        }

    def release(self) -> None:
        self.model = self.sample = None
        harness.free_device_memory()

    def _compared(self) -> dict:
        """The images compared: ``compare_images`` of the window's, drawn
        from the seed. Their latents, labels and the program's results, and
        at each kept evaluation the program's denoiser input (``x``,
        ``sigma``, with ``x_labels``) and output (``denoised``)."""
        window = self.done
        total = len(window) * self.n
        g = torch.Generator().manual_seed(self.ctx.subseed("compare"))
        picks = sorted(torch.randperm(total, generator=g)[:self.mix["compare_images"]].tolist())
        rows = [(window[i // self.n], i % self.n) for i in picks]
        out = {name: torch.stack([batch[j][r] for batch, r in rows])
               for j, name in enumerate(("latents", "labels", "sampled"))}
        kept = [(batch[3][k], batch[1][r], r) for batch, r in rows for k in sorted(batch[3])]
        for j, name in enumerate(("x", "sigma", "denoised")):
            out[name] = torch.stack([ev[j][r] for ev, _, r in kept]) if kept else None
        out["x_labels"] = torch.stack([y for _, y, _ in kept]) if kept else None
        return out

    def reference(self, c: dict, ops=None) -> tuple:
        """The reference's (or, given ``ops``, the control's) sampled
        latents of the compared images, and its denoiser at the program's
        inputs of the kept evaluations."""
        ops = ops or ref_model.Fp32Ops()
        with ref_model.exact_fp32():
            params = ref_model.make_params(self.spec, self.ctx.subseed("weights"),
                                           self.ctx.device)
            sampled = ref_sample.heun(params, self.cfg, c["latents"], c["labels"], self.mix, ops)
            denoised = None
            if c["x"] is not None:
                with torch.no_grad():
                    denoised = ref_model.denoise(params, self.cfg, c["x"].float(), c["sigma"],
                                                 c["x_labels"], None, ops,
                                                 cfg_scale=self.mix["cfg_scale"])
        del params
        harness.free_device_memory()
        return sampled, denoised

    def check(self) -> dict:
        c = self._compared()
        return gaps((c["sampled"], c["denoised"]), self.reference(c))

    def control(self, activations: bool = True) -> dict:
        """The control's readings: the reference in fp8 in the program's
        place, its activations in fp8 too (``activations``; fp8 products
        alone move the worst image only 2.3-3.3 times as far as the
        program's bf16 does)."""
        c = self._compared()
        return gaps(self.reference(c, Fp8Ops(activations=activations)), self.reference(c))


def image_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst image's |program - reference| / |reference| (L2 over the
    image's latent)."""
    diff = (program.float() - reference.float()).flatten(1).norm(dim=1)
    return float((diff / reference.float().flatten(1).norm(dim=1)).max())


def gaps(program: tuple, reference: tuple) -> dict:
    """The worst image's gap of the sampled latents (``sample_gap``) and of
    the denoiser's output at the kept evaluations (``denoise_gap``; no
    reading where nothing was kept)."""
    out = {"sample_gap": image_gap(program[0], reference[0])}
    if program[1] is not None and reference[1] is not None:
        out["denoise_gap"] = image_gap(program[1], reference[1])
    return out
