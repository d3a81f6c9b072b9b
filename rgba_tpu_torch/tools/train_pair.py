"""Train one mask codec (lambda 1024) and one RGB codec (``--lam``) on
the card and leave their checkpoints under ``--outdir``, where the
trained-weight probes (``int8_quality_probe``, ``deadzone_probe``,
``rate_gate_codec_probe``, ``preview_probe``) load them.  The RD sweep's
own pair at half its card time; resumes from the latest checkpoints.

    python -m rgba_tpu_torch.tools.train_pair --steps 1200 --lam 4096 \\
        --outdir build/proofs
"""

from __future__ import annotations

import os

from . import _common as c


def main(argv=None) -> None:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--lam", type=int, default=4096)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    get_data = c.lazy_data(device)

    c.train_one("mask", "mask", c.MASK_LAMBDA, args.steps, args.outdir,
                data=get_data)
    c.train_one(f"rgb_{args.lam}", "rgb", args.lam, args.steps, args.outdir,
                data=get_data)
    print("train_pair OK", flush=True)


if __name__ == "__main__":
    main()
