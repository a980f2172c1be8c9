"""Convert a reference PyTorch checkpoint (DeepSolo / GoMatching) to the JAX package's
``.npz`` params, the file every shipped config names, without JAX (the counterpart of
``tools/convert_torch_weights.py``).

    python -m gomatching_tpu_torch.tools.convert_torch_weights in.pth out.npz \\
        [--config configs/GoMatching_ICDAR15.yaml]

The input is a detectron2 ``.pkl`` (a latin1 pickle of ``{'model': {name: ndarray}}``) or
a ``.pth``, read as ``MODEL.WEIGHTS`` reads them (``engine/checkpoint.load_checkpoint``:
numpy's array globals only, nothing run from the file); the keys are mapped by the
config's model (``weights.convert``) and written with ``np.savez`` under '/'-joined paths.
Prints how many keys the model expects and the checkpoint lacks, and how many checkpoint
keys no parameter takes, as the repository's converter does. ``MODEL.WEIGHTS`` also takes
the ``.pkl`` or ``.pth`` itself.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "GoMatching_ICDAR15.yaml")


def main(argv: Optional[List[str]] = None) -> Tuple[List[str], List[str]]:
    """Returns (missing, unused) torch keys."""
    from ..config import setup_eval_cfg
    from ..engine.checkpoint import load_checkpoint, save_params
    from ..weights import convert

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--config", default=CONFIG)
    args = ap.parse_args(argv)

    cfg = setup_eval_cfg(args.config, ["MODEL.WEIGHTS", "''"])
    params, missing, unused = convert(load_checkpoint(args.input, "input"), cfg)
    if missing:
        print(f"WARNING: {len(missing)} expected keys missing, e.g. {missing[:5]}")
    if unused:
        print(f"note: {len(unused)} checkpoint keys unused, e.g. {unused[:5]}")
    save_params(args.output, params)
    print(f"wrote {args.output}")
    return missing, unused


if __name__ == "__main__":
    main()
