"""Train the TinyPoint learned extractor on synthetic shapes with the PyTorch
port and save the port's checkpoint
(sfmfromscratch_tpu_torch/weights/tinypoint_synth.npz), in the JAX package's
npz format, which both packages' ``load_flax_weights`` read.

Usage:
    python tools/train_superpoint_torch.py [steps]

Runs on the CUDA card and raises without one. See
sfmfromscratch_tpu_torch/ops/sp_train.py for the recipe;
tools/train_superpoint.py is the JAX package's counterpart.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    from sfmfromscratch_tpu_torch.ops.sp_train import train
    from sfmfromscratch_tpu_torch.ops.superpoint import save_flax_weights

    net = train(steps=steps)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "sfmfromscratch_tpu_torch", "weights")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(out_dir, "tinypoint_synth.npz"))
    save_flax_weights(path, net)
    print(f"saved {path} ({os.path.getsize(path) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
