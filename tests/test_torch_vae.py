"""The port's SD-VAE (maskdit_tpu_torch/models/vae.py) against the JAX one.

The same seeded numpy weights go into both: the JAX tree through
``vae_state_dict_from_flax``, at the full SD config (ch 128, mult 1/2/4/4,
2 res blocks: a 64x64 image and an 8x8 latent keep the CPU time down) and at
a small one (ch 32, mult 1/2, 1 res block). fp32 on the CPU; the bound is
the max error relative to max|ref|, 1e-4 (sums in other orders over up to
~30 convolutions; measured ~1e-6). Also: a released-layout file (the JAX
``export_vae``) loads strictly, and ``decode_images`` halves the batch on
an out-of-memory error only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import vae as jvae
from maskdit_tpu.utils import port as jport
from maskdit_tpu_torch.models.vae import AutoencoderKL
from maskdit_tpu_torch.sampling.generate import decode_images
from maskdit_tpu_torch.utils.port import load_vae, vae_state_dict_from_flax

REL = 1e-4
SMALL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=2)


def write_random_vae(path: str, seed: int = 0, std: float = 0.05) -> None:
    """A full-config SD-VAE checkpoint in the released layout, with every
    weight ~ N(0, std^2) from ``seed`` (the released file is not in the
    repository)."""
    g = torch.Generator().manual_seed(seed)
    state = AutoencoderKL().state_dict()
    for v in state.values():
        v.copy_(torch.randn(v.shape, generator=g) * std)
    torch.save(state, path)


def _small_jax_vae():
    class SmallVAE(jvae.AutoencoderKL):
        def setup(self):
            c = SMALL
            self.encoder = jvae.Encoder(ch=c["ch"], ch_mult=c["ch_mult"],
                                        num_res_blocks=c["num_res_blocks"],
                                        z_channels=c["z_channels"])
            self.decoder = jvae.Decoder(ch=c["ch"], ch_mult=c["ch_mult"],
                                        num_res_blocks=c["num_res_blocks"])
            self.quant_conv = jvae.Conv(2 * c["z_channels"], 1)
            self.post_quant_conv = jvae.Conv(c["z_channels"], 1)

    return SmallVAE(embed_dim=SMALL["z_channels"], z_channels=SMALL["z_channels"])


@pytest.fixture(scope="module", params=["sd", "small"])
def pair(request):
    if request.param == "sd":
        jax_vae, ours, image, zc = jvae.AutoencoderKL(), AutoencoderKL(), 64, 4
    else:
        jax_vae, ours = _small_jax_vae(), AutoencoderKL(embed_dim=2, **SMALL)
        image, zc = 16, 2
    shapes = jax.eval_shape(
        lambda: jax_vae.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, image, image)),
                             jax.random.PRNGKey(1)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    ours.load_state_dict(vae_state_dict_from_flax(params), strict=True)
    return jax_vae, params, ours.eval(), image, zc


def _assert_rel(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= REL, err


def test_encode_moments_matches_jax(pair):
    jax_vae, params, ours, image, zc = pair
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 3, image, image)).astype(np.float32)
    ref = jax_vae.apply({"params": params}, jnp.asarray(x), method="encode_moments")
    got = ours.encode_moments(torch.from_numpy(x))
    assert got.shape == (2, 2 * zc, 8, 8)
    _assert_rel(got.numpy(), np.asarray(ref))


def test_decode_matches_jax(pair):
    jax_vae, params, ours, image, zc = pair
    side = 8
    z = np.random.default_rng(2).normal(size=(2, zc, side, side)).astype(np.float32)
    ref = jax_vae.apply({"params": params}, jnp.asarray(z), method="decode")
    got = ours.decode(torch.from_numpy(z))
    _assert_rel(got.numpy(), np.asarray(ref))


def test_sample_z_with_injected_noise_matches_jax(pair):
    """The JAX ``sample_z`` draws its own noise, so the JAX side runs with a
    key whose draw is then injected into the port's."""
    jax_vae, params, ours, image, zc = pair
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(2, zc, 4, 4)).astype(np.float32)
    logvar = rng.uniform(-40, 25, size=(2, zc, 4, 4)).astype(np.float32)  # both clips
    moments = np.concatenate([mean, logvar], axis=1)
    key = jax.random.PRNGKey(7)
    ref = jax_vae.apply({"params": params}, key, jnp.asarray(moments), method="sample_z")
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    got = ours.sample_z(torch.from_numpy(moments), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # a generator draws the noise itself, reproducibly
    draws = [ours.sample_z(torch.from_numpy(moments), torch.Generator().manual_seed(0))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)


def test_released_layout_loads_strictly(tmp_path):
    """``export_vae`` writes the released ``autoencoder_kl.pth`` keys; the
    port loads such a file strictly and carries the same values as
    ``vae_state_dict_from_flax``."""
    model = jvae.AutoencoderKL()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)),
                                               jax.random.PRNGKey(1)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    released = jport.export_vae(params)
    path = str(tmp_path / "autoencoder_kl.pth")
    released = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in released.items()}
    torch.save(released, path)
    ours = load_vae(path)
    assert set(ours.state_dict()) == set(released)
    bridged = vae_state_dict_from_flax(params)
    for k, v in ours.state_dict().items():
        torch.testing.assert_close(v, bridged[k], rtol=0, atol=0)
    assert not any(p.requires_grad for p in ours.parameters()) and not ours.training
    torch.save({**released, "extra.weight": torch.zeros(1)}, path)
    with pytest.raises(RuntimeError, match="extra.weight"):
        load_vae(path)


class FakeVAE:
    """Decodes z to -z; runs out of device memory above ``limit`` latents."""

    def __init__(self, limit: int, error=torch.cuda.OutOfMemoryError):
        self.limit, self.error, self.calls = limit, error, []

    def decode(self, z):
        self.calls.append(z.shape[0])
        if z.shape[0] > self.limit:
            raise self.error("CUDA out of memory (fake)")
        return -z


def test_decode_images_halves_on_out_of_memory_only():
    z = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3, 1, 1)
    fake = FakeVAE(limit=2)
    np.testing.assert_array_equal(decode_images(fake, z), -z.numpy())
    assert fake.calls == [8, 4, 2, 2, 2, 2]
    # a ragged batch splits too; past max_split the error propagates
    fake = FakeVAE(limit=1)
    np.testing.assert_array_equal(decode_images(fake, z[:3], max_split=2), -z[:3].numpy())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        decode_images(FakeVAE(limit=1), z, max_split=2)
    # another error propagates at once
    fake = FakeVAE(limit=2, error=ValueError)
    with pytest.raises(ValueError):
        decode_images(fake, z)
    assert fake.calls == [8]
