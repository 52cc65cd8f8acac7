"""Activation rematerialisation of the DiT blocks: the JAX model's ``remat``
(maskdit_tpu/models/dit.py:122-126, :167-199; the names at layers.py:217-351).

The JAX model wraps every encoder and decoder block in ``nn.remat`` with a
policy that says which of the block's values its backward keeps; it
recomputes the rest from them. Here a block (``layers.DiTBlock``) is a chain
of named stages (``DiTBlock.STAGES``) and a policy is the set of stage
outputs it keeps besides the block's inputs (x, c, kv_valid):

  full        none: the backward reruns the whole block (``nn.remat``);
  dots        every GEMM's output, ``mod`` (adaLN), ``qkv_out``, ``attn_out``,
              ``fc1_out``, ``mlp_out`` (``checkpoint_policies.checkpoint_dots``);
  names       ``h_msa``, ``qkv_out``, ``attn_out``, ``h_mlp``, ``fc1_out``,
              ``mlp_out`` (``save_only_these_names``);
  names_lite  ``h_msa``, ``attn_out``, ``h_mlp``, ``mlp_out``.

How. The block's forward runs once under autograd, as without remat, so its
backward is autograd's own graph and the gradients are bit for bit those of
no remat. A ``saved_tensors_hooks`` pair stands between that graph and what
it saves (torch.utils.checkpoint's mechanism, made selective): a parameter
(or a view of one) is kept as autograd keeps it; a parameter's cast to the
compute dtype is cast again when the backward asks for it (JAX keeps no
cast either); a view of a block input or of a kept output is saved once,
by ``_Keep``, a node after the block (which is what ``saved_tensors_hooks``
around a block sees); every other saved tensor is dropped. When the
backward first asks for a dropped one, the stages that produce dropped
tensors rerun from the kept ones (``_Frame.replay``), in order, on the
forward's kernels and shapes, and their saved tensors are taken in the
order the forward saved them. A stage whose saved tensors are all kept and
whose output is not needed does not rerun: under ``names`` no GEMM reruns
but adaLN's, under ``names_lite`` also qkv's and fc1's, under ``dots``
none. The frame that holds a block's recomputed values dies with the
block's last backward node, so they never pile up over the blocks.

Attention's output before ``proj`` is no value a policy keeps (in JAX a
Pallas output is not a dot and bears no name), and proj's weight gradient
needs it: under every policy the backward reruns the attention forward, one
more forward launch per block and train step (#1 on train256's shapes). The
JAX grad holds likewise three ``pallas_call``s per block under each policy
against two without. Inside a rematerialised block the plain and flash
routes run without the layer's own checkpoint: the block recomputes them.

On the mesh (parallel/sharded.py) a block is an FSDP unit whose
parameters are views into a buffer that is freed after the block's forward
and gathered again when the gradient reaches the block's output, which is
``_Keep``'s: so before ``_Keep`` publishes the kept values and before any
recompute. A saved parameter (or its cast, cast again in ``unpack``) is
read when the backward asks for it, from the gathered buffer. The storage
keys of ``register`` are looked up only while the block's forward runs,
when every registered value is alive (two live storages have two
addresses), and are dropped when it returns: a storage the allocator
hands on later (a freed unit buffer, another block's activations) can
match no key. The tensor group's sums of proj and fc2 save nothing, so a
stage's save count is the same with and without a tensor axis.
"""

from __future__ import annotations

from typing import Optional

import torch

# the stage outputs each policy keeps (JAX dit.py:167-199)
POLICIES = {
    "full": (),
    "dots": ("mod", "qkv_out", "attn_out", "fc1_out", "mlp_out"),
    "names": ("h_msa", "qkv_out", "attn_out", "h_mlp", "fc1_out", "mlp_out"),
    "names_lite": ("h_msa", "attn_out", "h_mlp", "mlp_out"),
}
INPUTS = ("x", "c", "kv_valid")


def policy_of(remat) -> Optional[str]:
    """The policy for a JAX ``remat`` value: None (no remat) for False or
    'none', 'full' for True. The JAX model runs an unknown value without
    remat (dit.py:197-198); here it raises."""
    if remat is None or remat is False or remat == "none":
        return None
    if remat is True:
        return "full"
    if isinstance(remat, str) and remat in POLICIES:
        return remat
    raise ValueError(f"unknown remat policy {remat!r}: one of False / 'none', True / 'full', "
                     f"{', '.join(repr(p) for p in list(POLICIES)[1:])}")


def _cast_parameter(base: torch.Tensor) -> Optional[torch.Tensor]:
    """The parameter that ``base`` is a cast of (a Linear's weight in the
    compute dtype), else None."""
    fn = base.grad_fn
    if type(fn).__name__ != "ToCopyBackward0" or len(fn.next_functions) != 1:
        return None
    source = fn.next_functions[0][0]
    return source.variable if type(source).__name__ == "AccumulateGrad" else None


def _tensors(value) -> tuple:
    if value is None:
        return ()
    return tuple(value) if isinstance(value, tuple) else (value,)


def _detached(value):
    """A value (a tensor or a tuple of them) detached, with its
    ``requires_grad``: a recompute's input routes as the forward's did."""
    out = tuple(t.detach().requires_grad_(t.requires_grad) for t in _tensors(value))
    return out if isinstance(value, tuple) else (out[0] if out else None)


class _Keep(torch.autograd.Function):
    """Identity on the block's output that saves the block's inputs and kept
    outputs, and hands them to the frame when the backward reaches it,
    before any of the block's own nodes."""

    @staticmethod
    def forward(ctx, frame, out, *kept):
        ctx.frame = frame
        ctx.save_for_backward(*kept)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        # the node outlives the backward (the graph lives while the loss
        # does): let go of the frame, which the block's nodes then hold
        # until the last of them has run, so that what it recomputed is
        # freed block by block
        frame, ctx.frame = ctx.frame, None
        frame.publish(ctx.saved_tensors)
        return (None, grad) + (None,) * len(ctx.saved_tensors)


class _Frame:
    """One rematerialised call of a block: what its forward saved, by stage
    and position, and the values its backward recomputes."""

    def __init__(self, block, policy: str):
        self.block = block
        self.keep = set(INPUTS) | set(POLICIES[policy])
        self.stage, self.position = "", 0
        self.saves: dict[str, int] = {}  # tensors saved per stage in the forward
        self.dropped: set = set()  # (stage, position) of the dropped ones
        # storage -> (value, index, offset), while the forward runs
        self.storages: dict[int, tuple] = {}
        self.run: set = set()  # the stages the recompute reruns
        self.layout: list = []  # (name, is a tuple, count) of what _Keep saved
        self.values: Optional[dict] = None  # the kept and the recomputed values
        self.recomputed: dict = {}  # (stage, position) -> the dropped tensor
        self.replayed = False

    def register(self, name: str, value) -> None:
        """A value's storage, for the saved views of it (the forward's local
        values keep it from being reused until the block returns)."""
        for i, t in enumerate(_tensors(value)):
            ptr = t.untyped_storage().data_ptr()
            if ptr and ptr not in self.storages:
                self.storages[ptr] = (name, i, t.storage_offset())

    def pack(self, t: torch.Tensor):
        position, self.position = self.position, self.position + 1
        base = t._base if t._is_view() else t
        if base.grad_fn is None:  # a parameter or a constant (or a view of one)
            return t
        param = _cast_parameter(base)
        if param is not None:  # cast again when the backward asks, as JAX does
            return ("cast", param, base.dtype, t.size(), t.stride(),
                    t.storage_offset() - base.storage_offset())
        source = self.storages.get(t.untyped_storage().data_ptr())
        if source is not None:
            name, index, offset = source
            if name not in self.keep:
                self.run.add(name)
            return ("view", name, index, t.size(), t.stride(), t.storage_offset() - offset)
        self.dropped.add((self.stage, position))
        return ("dropped", self.stage, position)

    def unpack(self, slot):
        if isinstance(slot, torch.Tensor):
            return slot
        if slot[0] == "cast":
            _, param, dtype, size, stride, offset = slot
            cast = param.detach().to(dtype)
            return cast.as_strided(size, stride, cast.storage_offset() + offset)
        if self.values is None:
            raise RuntimeError("remat: a block's saved tensors were asked for before its "
                               "output's gradient reached it")
        if slot[0] == "dropped":
            self.replay()
            return self.recomputed[slot[1:]]
        _, name, index, size, stride, offset = slot
        if name not in self.keep:
            self.replay()
        base = _tensors(self.values[name])[index].detach()
        return base.as_strided(size, stride, base.storage_offset() + offset)

    def forward(self, x, c, kv_valid):
        values = {"x": x, "c": c, "kv_valid": kv_valid}
        for name in INPUTS:
            self.register(name, values[name])
        with torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack):
            for name, inputs in self.block.STAGES:
                self.stage, self.position = name, 0
                values[name] = self.block.stage(name, *(values[i] for i in inputs),
                                                own_checkpoint=False)
                self.saves[name] = self.position
                self.register(name, values[name])
        self.storages.clear()  # the keys serve the forward only: storages are reused after it
        kept = [n for n in values if n in self.keep]
        self.layout = [(n, isinstance(values[n], tuple), len(_tensors(values[n]))) for n in kept]
        # the recompute reruns every stage with a dropped tensor or a needed
        # output, and the stages these need that are not kept
        self.run |= {stage for stage, _ in self.dropped}
        for name, inputs in reversed(self.block.STAGES):
            if name in self.run:
                self.run.update(i for i in inputs if i not in self.keep)
        return _Keep.apply(self, values["out"], *(t for n in kept for t in _tensors(values[n])))

    def publish(self, saved: tuple) -> None:
        """The kept values, from _Keep's backward."""
        values, i = {}, 0
        for name, is_tuple, count in self.layout:
            part = tuple(_detached(t) for t in saved[i:i + count])
            values[name] = part if is_tuple else (part[0] if part else None)
            i += count
        self.values = values

    def replay(self) -> None:
        """Rerun the stages in ``run`` from the kept values, once, keeping
        the saved tensors that the forward dropped."""
        if self.replayed:
            return
        block, values = self.block, self.values
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                self._capture, lambda _: None):
            for name, inputs in block.STAGES:
                if name not in self.run:
                    continue
                self.stage, self.position = name, 0
                out = block.stage(name, *(values[i] for i in inputs), own_checkpoint=False)
                if self.position != self.saves[name]:
                    raise RuntimeError(
                        f"remat: the recompute of stage {name!r} saved {self.position} tensors, "
                        f"its forward {self.saves[name]}")
                if name not in self.keep:
                    values[name] = _detached(out)
        self.replayed = True

    def _capture(self, t: torch.Tensor) -> None:
        key = (self.stage, self.position)
        self.position += 1
        if key in self.dropped:
            self.recomputed[key] = t.detach()


def rematerialise(block, policy: str, x: torch.Tensor, c: torch.Tensor,
                  kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``block(x, c, kv_valid)`` whose backward keeps only what ``policy``
    keeps and recomputes the rest."""
    return _Frame(block, policy).forward(x, c, kv_valid)
