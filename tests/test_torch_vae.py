"""Port vs JAX package: the SVD VAE (tiny widths, f32, CPU).

The tiny VAE is built in torch; the JAX variables come from its
``state_dict()`` through ``scripts/convert_svd_vae.py``'s ``convert``, an
independent oracle of the name and layout mapping (a Flax init of the same
VAE would cost far more compile time than the two applies). ``convert``
hard-codes 4 blocks of 2 (encoder) and 3 (decoder) resnets, so the tiny VAE
is 4 blocks of 32 channels: 32 px frames, 4x4 latents.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.models.vae import GN as JGN
from lfvdm_tpu.models.vae import SVDVae as JSVDVae
from lfvdm_tpu.models.vae import TemporalDecoder as JTemporalDecoder
from lfvdm_tpu.models.vae import decoder_config_from_params
from lfvdm_tpu_torch.models import vae as tvae
from lfvdm_tpu_torch.utils.convert import vae_state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from convert_svd_vae import convert, flatten  # noqa: E402

TINY = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=2, latent_channels=4)
PARITY = 1e-5  # relative L2, f32 on both sides


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def tiny_vae_pair(seed=0):
    """The tiny VAE in both packages with the same weights: the port's
    default init, every parameter (GroupNorm affine and mix factors too)
    moved by seeded noise so that each one's mapping shows."""
    vae = tvae.SVDVae(seed=seed, device="cpu", **TINY)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in vae.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    enc_vars, dec_vars = convert({k: v.numpy() for k, v in vae.state_dict().items()})
    return vae, JSVDVae(variables=(enc_vars, dec_vars))


def write_npz_pair(jvae, prefix):
    """The ``<prefix>_{encoder,decoder}.npz`` pair scripts/convert_svd_vae.py
    writes, of the JAX VAE's variables."""
    np.savez(f"{prefix}_encoder.npz", **flatten(jax.tree.map(np.asarray, jvae.enc_vars)))
    np.savez(f"{prefix}_decoder.npz", **flatten(jax.tree.map(np.asarray, jvae.dec_vars)))


@pytest.fixture(scope="module")
def pair():
    return tiny_vae_pair()


def video(seed, B=2, T=3, S=32):
    return np.random.default_rng(seed).uniform(-1, 1, (B, T, 3, S, S)).astype(np.float32)


def test_encoder_moments_match_jax(pair):
    vae, jvae = pair
    frames = video(1).reshape(6, 3, 32, 32)
    ref = np.asarray(jvae._encode(jnp.asarray(frames.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = vae.moments(torch.from_numpy(frames)).numpy()
    assert got.shape == (6, 8, 4, 4)
    assert rel_l2(got, ref) <= PARITY


def test_encode_video_mean_matches_jax(pair):
    vae, jvae = pair
    x = video(2)
    ref = np.asarray(jvae.encode_video(x))
    got = vae.encode_video(x, chunk_size=4)  # chunks of another size: the same latents
    assert got.shape == ref.shape == (2, 3, 4, 4, 4)
    assert rel_l2(got.numpy(), ref) <= PARITY


def test_decode_video_matches_jax(pair):
    vae, jvae = pair
    z = np.random.default_rng(3).standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    ref = np.asarray(jvae.decode_video(z))
    got = vae.decode_video(z)
    assert got.shape == ref.shape == (2, 3, 3, 32, 32)
    assert rel_l2(got.numpy(), ref) <= PARITY


def test_decoder_over_frames_matches_jax(pair):
    """num_frames = 3: the temporal resnets' (T, H, W) GroupNorm statistics
    and the (3, 1, 1) convs with a real temporal extent, which the per-frame
    decode never exercises."""
    vae, jvae = pair
    z = np.random.default_rng(4).standard_normal((6, 4, 4, 4)).astype(np.float32)
    dec = JTemporalDecoder(**decoder_config_from_params(jvae.dec_vars))
    apply = jax.jit(lambda v, x: dec.apply(v, x, num_frames=3))
    ref = np.asarray(apply(jvae.dec_vars, jnp.asarray(z.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = vae.decoder(torch.from_numpy(z), num_frames=3).numpy()
    assert rel_l2(got, ref) <= PARITY


def test_group_norm_eps_and_statistics_match_jax():
    """eps 1e-6 shows on an input whose variance is 1e-6 (eps 1e-5 would
    shrink the output by 2.3x); a 5-D input's statistics span (T, H, W), as
    the JAX GN's on its (B, T, H, W, C) layout."""
    rng = np.random.default_rng(5)
    x = (1e-3 * rng.standard_normal((2, 64, 3, 4, 4))).astype(np.float32)
    gn = tvae.GroupNorm(64)
    assert gn.eps == 1e-6 and gn.num_groups == 32
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
        gn.bias.copy_(torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
        got = gn(torch.from_numpy(x)).numpy()
    params = {"params": {"scale": gn.weight.detach().numpy(), "bias": gn.bias.detach().numpy()}}
    ref = np.asarray(JGN().apply(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    np.testing.assert_allclose(got, ref.transpose(0, 4, 1, 2, 3), atol=1e-5, rtol=1e-5)


def test_state_dict_round_trip_is_exact(pair):
    vae, _ = pair
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    back = vae_state_dict_from_jax(*convert(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and np.array_equal(back[k].numpy(), v), k


def test_names_are_diffusers(pair):
    vae, _ = pair
    names = set(vae.state_dict())
    for key in ("encoder.down_blocks.0.resnets.1.conv2.weight",
                "encoder.down_blocks.2.downsamplers.0.conv.weight",
                "encoder.mid_block.attentions.0.to_out.0.weight",
                "encoder.mid_block.resnets.1.norm1.bias", "quant_conv.weight",
                "decoder.up_blocks.3.resnets.2.temporal_res_block.conv1.weight",
                "decoder.up_blocks.0.resnets.0.time_mixer.mix_factor",
                "decoder.up_blocks.2.upsamplers.0.conv.bias", "decoder.time_conv_out.weight",
                "decoder.conv_norm_out.weight"):
        assert key in names, key
    assert "encoder.down_blocks.3.downsamplers.0.conv.weight" not in names
    assert vae.state_dict()["decoder.time_conv_out.weight"].shape == (3, 3, 3, 1, 1)


def test_load_svd_vae_from_an_npz_pair(pair, tmp_path):
    vae, jvae = pair
    prefix = str(tmp_path / "svd_vae")
    write_npz_pair(jvae, prefix)
    loaded = tvae.load_svd_vae(prefix, device="cpu")
    assert loaded.pretrained and not vae.pretrained
    own = vae.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_decode_is_per_frame(pair):
    """Frame by frame equals one chunk: no frame sees another through the
    temporal blocks or time_conv_out; decoding the frames as one clip would
    mix them."""
    vae, _ = pair
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 4, 4, 4, 4))
                         .astype(np.float32))
    whole = vae.decode_video(z, chunk_size=20)
    one_by_one = vae.decode_video(z, chunk_size=1)
    torch.testing.assert_close(one_by_one, whole, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        as_clip = vae.decoder(z[0], num_frames=4)
    assert rel_l2(as_clip.numpy(), whole[0].numpy()) > 1e-3


def test_encode_draws_only_from_the_generator(pair):
    vae, _ = pair
    x = video(7, B=1)
    a = vae.encode_video(x, generator=torch.Generator().manual_seed(1))
    b = vae.encode_video(x, generator=torch.Generator().manual_seed(1))
    c = vae.encode_video(x, generator=torch.Generator().manual_seed(2))
    mean = vae.encode_video(x)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, mean)
    assert torch.equal(vae.encode(x), mean)


def test_config_is_read_from_the_weights():
    src = tvae.SVDVae(block_out_channels=(32, 64), layers_per_block=1, latent_channels=2,
                      device="cpu")
    sd = src.state_dict()
    assert tvae.encoder_config_from_state_dict(sd) == dict(
        block_out_channels=(32, 64), layers_per_block=1, latent_channels=2, in_channels=3)
    assert tvae.decoder_config_from_state_dict(sd) == dict(
        block_out_channels=(32, 64), layers_per_block=1, out_channels=3, latent_channels=2)
    built = tvae.SVDVae(sd, device="cpu")  # the widths given here are ignored
    assert built.pretrained and built.latent_channels == 2
    z = built.encode_video(video(8, B=1, T=2, S=16))
    assert z.shape == (1, 2, 2, 8, 8)
    assert built.decode_video(z).shape == (1, 2, 3, 16, 16)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvae.SVDVae(**TINY)
