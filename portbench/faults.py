"""Faults planted in the program, for showing that ``correct`` catches them.

Each is a context manager that patches the program (or the run's feed)
while it is open:

  * ``unchanged``: each step returns its state unchanged (training: the
    optimizer's update does nothing but count; sampling: every Heun step
    returns its input, so the sampler returns its starting point);
  * ``half_batch``: the train step sees half of each batch, so the loss and
    the gradient are the mean over the rest;
  * ``token``: a token altered where it is produced (training: the
    decoder's scatter of the kept tokens lands each one place off;
    sampling: the network's output tokens each one place off).

A single card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def unchanged(kind: str):
    if kind == "train":
        from maskdit_tpu_torch.ops import fused_adam

        def update_with_ema(self, grads, state, *args, **kwargs):
            state.count += 1

        return _patched(fused_adam.FusedAdamEma, "update_with_ema", update_with_ema)
    from maskdit_tpu_torch.sampling import generate

    def sampler(denoise_fn, latents, generator=None, sigma_max=80.0, **kwargs):
        return latents.float() * sigma_max

    return _patched(generate, "edm_sampler", sampler)


def half_batch(run):
    """Patches ``run`` (a train ``Run``): its program sees the first half of
    each feed's rows."""
    inputs = run._program_inputs

    def first_half(feed):
        return inputs({k: v[:run.n // 2] for k, v in feed.items()})

    return _patched(run, "_program_inputs", first_half)


def token(kind: str):
    from maskdit_tpu_torch.models import dit, masking

    if kind == "train":
        scatter = masking.scatter_tokens

        def shifted(*args, **kwargs):
            return scatter(*args, **kwargs).roll(1, dims=1)

        return _patched(masking, "scatter_tokens", shifted)
    unpatchify = dit.MaskDiT.unpatchify

    def shifted_out(self, x):
        return unpatchify(self, x.roll(1, dims=1))

    return _patched(dit.MaskDiT, "unpatchify", shifted_out)


def plant(name: str, kind: str, run):
    """The fault ``name`` for a run of ``kind`` ('train' or 'sample')."""
    if name == "half_batch":
        return half_batch(run)
    return {"unchanged": unchanged, "token": token}[name](kind)
