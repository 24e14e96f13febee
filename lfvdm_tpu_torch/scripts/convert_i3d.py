"""Convert the TF-Hub I3D (Kinetics-400) graph into the ``.npz`` both
packages read, and check the port's I3D against it (counterpart of the
repo's scripts/convert_i3d.py).

    python -m lfvdm_tpu_torch.scripts.convert_i3d --out weights/i3d_kinetics400.npz [--device cuda]

Needs the ``tensorflow`` and ``tensorflow_hub`` packages (the module
downloads the first time). The hub module is built in a TF1 graph of its
own (``tf.Graph().as_default()``, which keeps TF's eager mode for the rest
of the process); its variables go to the flat ``.npz`` under the JAX
package's keys (``utils.convert.i3d_npz_entry_from_tf``), the file the JAX
script writes, so ``$LFVDM_I3D_WEIGHTS`` and ``--i3d_weights`` name one file
for both packages. Then the port's ``I3DFeatureExtractor`` on that file, on
``--device`` in f32, is held to the graph's logits on a seeded
(1, 16, 224, 224, 3) clip to 1e-3. A mismatch raises after the file is
written.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

from ..evals.i3d import I3DFeatureExtractor
from ..utils.convert import i3d_npz_entry_from_tf
from ..utils.device import resolve_device

HUB_URL = "https://tfhub.dev/deepmind/i3d-kinetics-400/1"
CLIP = (1, 16, 224, 224, 3)


def create_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="weights/i3d_kinetics400.npz")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def convert(variables: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The graph's variables by name (``:0`` or not) -> the ``.npz`` dict."""
    return dict(i3d_npz_entry_from_tf(name.split(":")[0], np.asarray(value))
                for name, value in variables.items())


def main(argv=None):
    """Returns the written ``.npz`` path."""
    args = create_argparser().parse_args(argv)
    device = resolve_device(args.device)
    try:
        import tensorflow.compat.v1 as tf
        import tensorflow_hub as hub
    except ImportError as e:
        raise ImportError("convert_i3d needs the tensorflow and tensorflow_hub packages") from e

    clip = np.random.default_rng(0).uniform(-1, 1, CLIP).astype(np.float32)
    with tf.Graph().as_default():
        module = hub.Module(HUB_URL)
        inp = tf.placeholder(tf.float32, list(CLIP))
        logits = module(inp)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            sess.run(tf.tables_initializer())
            variables = {var.name: sess.run(var) for var in tf.global_variables()}
            ref_logits = sess.run(logits, {inp: clip})

    out = convert(variables)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **out)
    print(f"saved {args.out} ({len(out)} tensors)")

    ours = I3DFeatureExtractor(weights_path=args.out, device=device)(clip)
    print("max abs diff:", np.abs(ours - ref_logits).max())
    np.testing.assert_allclose(ours, ref_logits, rtol=1e-3, atol=1e-3)
    print("validation OK")
    return args.out


if __name__ == "__main__":
    main()
