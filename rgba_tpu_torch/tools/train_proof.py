"""Sustained training proof on the card, then the crash-resume check.

Trains both codecs (bf16, batch 16, lambda 1024, the four kernels on) on
synthetic 256x256 RGBA held on the device, writes each loss curve to
``<outdir>/{mask,rgb}_curve.jsonl`` (step, rd_loss, bpp, mse), then
checkpoints the params, takes one step on a fixed batch with a seeded
noise generator, builds a fresh trainer, loads the checkpoint and takes
the same step: the two losses must agree within 1e-4 relative (a step's
loss comes from its incoming params; the Adam moments restart fresh, the
reference's resume semantics).

    python -m rgba_tpu_torch.tools.train_proof --steps 300 \\
        --outdir build/proofs
"""

from __future__ import annotations

import json
import os
import shutil

from . import _common as c

DATA_N = 256


def run(kind: str, steps: int, outdir: str, data: dict,
        batch_size: int = 16, dtype: str = "bfloat16") -> dict:
    """Train ``kind`` from scratch for ``steps`` steps, write its curve and
    run the crash-resume check; returns the curve's ends, steps/s and the
    check's losses."""
    name = f"train_proof_{kind}"
    shutil.rmtree(os.path.join(outdir, f"{name}_ck"), ignore_errors=True)
    res = c.train_one(name, kind, 1024, steps, outdir, data=data,
                      batch_size=batch_size, dtype=dtype, log_every=50)
    with open(os.path.join(outdir, f"{kind}_curve.jsonl"), "w") as f:
        for point in res["curve"]:
            f.write(json.dumps(point) + "\n")
    batch = {k: data[k][:batch_size] for k in res["trainer"].batch_keys}
    parity = c.resume_parity(kind, res, batch)
    curve = res["curve"]
    c.log(f"{kind}: rd {curve[0]['rd_loss']:.3f} -> {curve[-1]['rd_loss']:.3f}"
          f" in {steps} steps, {res['steps_per_s']:.3f} steps/s "
          f"({res['steps_per_s'] * batch_size:.2f} img/s)")
    if not parity["rel"] <= c.RESUME_RTOL:
        raise AssertionError(f"{kind}: the resumed loss differs by "
                             f"{parity['rel']:.3g} relative")
    return {"first_rd": curve[0]["rd_loss"], "last_rd": curve[-1]["rd_loss"],
            "steps": steps, "steps_per_s": res["steps_per_s"],
            "resume": parity}


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    data = c.synth_data(DATA_N, device=device)
    out = {kind: run(kind, args.steps, args.outdir, data)
           for kind in ("mask", "rgb")}
    out["device"] = c.card() if device.type == "cuda" else "cpu"
    with open(os.path.join(args.outdir, "train_proof.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("train_proof OK", flush=True)
    return out


if __name__ == "__main__":
    main()
