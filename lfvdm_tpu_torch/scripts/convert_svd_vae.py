"""Convert diffusers' SVD VAE into the ``.npz`` pair both packages read, and
check the port's VAE against it (counterpart of the repo's
scripts/convert_svd_vae.py).

    python -m lfvdm_tpu_torch.scripts.convert_svd_vae --out weights/svd_vae [--device cuda]

Needs the ``diffusers`` package (``from_pretrained`` downloads the weights
the first time). Writes ``<out>_encoder.npz`` and ``<out>_decoder.npz``: the
JAX package's encoder and decoder variables flattened with "/", the files
the JAX script writes, so ``$LFVDM_VAE_WEIGHTS`` and ``--vae_weights`` name
one pair for both packages. Then ``load_svd_vae`` reads the pair back on
``--device`` and the port's modules are held against diffusers' there, in
f32 with TF32 off, to 1e-3: the encoder's moments of a (1, 3, 64, 64) frame,
and the decoder over 4 frames of 8x8 latents (the cross-frame GroupNorm and
the (3, 1, 1) time convs). A mismatch raises after the files are written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..models.vae import load_svd_vae
from ..utils.convert import flatten_tree, vae_jax_from_state_dict
from ..utils.device import full_f32, resolve_device

SOURCE = "stabilityai/stable-video-diffusion-img2vid"
CHECK_FRAMES = 4


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="weights/svd_vae")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def convert(state_dict):
    """diffusers' ``AutoencoderKLTemporalDecoder`` state dict (tensors or
    numpy) -> the (encoder, decoder) ``.npz`` dicts."""
    enc_vars, dec_vars = vae_jax_from_state_dict(state_dict)
    return flatten_tree(enc_vars), flatten_tree(dec_vars)


def check(source, ours, device):
    """The port's VAE ``ours`` against diffusers' ``source`` on ``device``."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)).to(device)
    lat = torch.from_numpy(rng.standard_normal((CHECK_FRAMES, ours.latent_channels, 8, 8))
                           .astype(np.float32)).to(device)
    with torch.no_grad(), full_f32():
        pairs = {"encoder": (ours.moments(img), source.quant_conv(source.encoder(img))),
                 "decoder": (ours.decoder(lat, num_frames=CHECK_FRAMES),
                             source.decoder(lat, num_frames=CHECK_FRAMES))}
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-3, atol=1e-3)
        print(f"{name} validation OK")


def main(argv=None):
    """Returns the ``--out`` prefix of the written pair."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    try:
        from diffusers import AutoencoderKLTemporalDecoder
    except ImportError as e:
        raise ImportError("convert_svd_vae needs the diffusers package") from e

    vae = AutoencoderKLTemporalDecoder.from_pretrained(SOURCE, subfolder="vae")
    vae.eval()
    enc, dec = convert(vae.state_dict())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(f"{out}_encoder.npz", **enc)
    np.savez(f"{out}_decoder.npz", **dec)
    print(f"saved {out}_encoder.npz / {out}_decoder.npz")
    check(vae.to(device), load_svd_vae(str(out), device=device), device)
    return str(out)


if __name__ == "__main__":
    main()
