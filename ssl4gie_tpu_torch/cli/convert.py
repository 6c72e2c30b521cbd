"""Checkpoint converter CLI (port of `ssl4gie_tpu/cli/convert.py`; the
reference's `convert_to_deit.py`):

  python -m ssl4gie_tpu_torch.cli.convert --input moco.pth.tar \
      --arch vit_b --output converted.pt

Reads any of the reference's formats (a timm-named state dict, the
{'model'|'state_dict': ...} wrappers, the DDP 'module.' and
'module.base_encoder.' prefixes, MoCo v3's ConvStem, a torchvision
ResNet-50, a timm AugReg .npz) or one of the port's exports, and writes
the port's export format: one `torch.save` file, {'params': {name:
tensor}, 'meta': {'epoch': 0, 'source': path}}, holding the encoder's
tensors under the port's backbone names (a ResNet-50's BatchNorm running
statistics included), which `--checkpoint` loads into every task model.
The JAX package writes an Orbax directory instead; the port reads torch
files only.
"""

import argparse
import os

import numpy as np


def convert(input_path: str, arch: str = "vit_b") -> dict:
    """The encoder's tensors of `input_path` under the port's names."""
    from ssl4gie_tpu_torch.convert.loaders import read_state_dict
    from ssl4gie_tpu_torch.convert.torch_names import (resnet_encoder,
                                                       vit_encoder,
                                                       vit_from_augreg_npz)
    if input_path.endswith(".npz"):
        return vit_from_augreg_npz(np.load(input_path))
    sd = read_state_dict(input_path)
    return vit_encoder(sd) if arch == "vit_b" else resnet_encoder(sd)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True,
                   help=".pth / .pth.tar / .pt / .npz checkpoint")
    p.add_argument("--arch", default="vit_b", choices=["vit_b", "resnet50"])
    p.add_argument("--output", required=True, help="output .pt file")
    args = p.parse_args(argv)

    from ssl4gie_tpu_torch.core.checkpoint import CheckpointManager
    params = {k: v.detach().to("cpu", copy=True).contiguous()
              for k, v in convert(args.input, args.arch).items()}
    print(f"converted {len(params)} tensors")
    path = os.path.abspath(args.output)
    name = os.path.basename(path).removesuffix(".pt")
    CheckpointManager(os.path.dirname(path), name).save(
        {"params": params, "meta": {"epoch": 0, "source": args.input}})
    print(f"wrote {os.path.join(os.path.dirname(path), name + '.pt')}")
    return params


if __name__ == "__main__":
    main()
