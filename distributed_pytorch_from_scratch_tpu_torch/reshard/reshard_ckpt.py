"""reshard_ckpt — offline any-layout → any-layout checkpoint reshard, the
port's counterpart of the JAX `scripts/reshard_ckpt.py`, with its flags.

A source checkpoint (a stamped npz set, an unstamped one, or a reference
`.pth` rank span) and a target layout (`--tp`, `--dp`, `--zero`) give a
new `validate_checkpoint`-clean rank-file set at the target tp, stamped
with the target layout. Leaves stream one at a time (`reshard/apply.py`):
the host holds at most the largest single leaf, never the tree.

    # a pp 2 training checkpoint -> a tp 2 serving set
    python -m distributed_pytorch_from_scratch_tpu_torch.reshard.reshard_ckpt \\
        --src ckpts --dst ckpts_tp2 --tp 2
    # a tp 4 set -> the dp 2 x tp 2 restart layout at ZeRO 1
    python -m distributed_pytorch_from_scratch_tpu_torch.reshard.reshard_ckpt \\
        --src ckpts --dst ckpts_el --tp 2 --dp 2 --zero 1 --model 45m

One JSON record goes to stdout (the plan's op counts, bytes moved, wall
ms, peak host bytes, and the run's config, its fingerprint and the git
revision: JAX's record); the summary goes to stderr in words. Runs on the
host alone: no card, no process group.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True,
                   help="source checkpoint dir (tprank-*.npz or, with "
                        "--ext pth, a reference .pth rank span)")
    p.add_argument("--dst", required=True,
                   help="output dir for the resharded shard set")
    p.add_argument("--iter", type=int, default=None,
                   help="iteration to reshard (default: latest in --src)")
    p.add_argument("--tp", type=int, required=True,
                   help="target tensor-parallel width (shard file count)")
    p.add_argument("--dp", type=int, default=1,
                   help="target data-parallel width (stamped for the "
                        "loader's ZeRO ownership; files hold globals)")
    p.add_argument("--zero", type=int, default=0, choices=(0, 1, 2, 3),
                   help="target ZeRO stage (stamped into the new layout)")
    p.add_argument("--ext", choices=("npz", "pth"), default="npz",
                   help="source format (pth = legacy reference span, "
                        "bridged through interop)")
    p.add_argument("--model", default=None,
                   help="model preset — REQUIRED for legacy sources "
                        "(no __layout__ stamp): supplies the spec tree "
                        "the layout is inferred onto")
    p.add_argument("--plan_only", action="store_true",
                   help="print the plan summary and exit without writing")
    args = p.parse_args(argv)
    if args.tp < 1 or args.dp < 1:
        p.error("--tp/--dp must be >= 1")
    return args


def _git_rev() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=here,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def run_stamp(config: dict) -> dict:
    """The JAX record's provenance fields: the run's config, its
    fingerprint and the git revision ("unknown" outside a checkout)."""
    cfg = {k: config[k] for k in sorted(config)}
    text = json.dumps(cfg, sort_keys=True, default=str)
    return {"config": cfg,
            "config_fingerprint": hashlib.sha256(
                text.encode()).hexdigest()[:16],
            "git_rev": _git_rev()}


def model_specs(preset: str):
    """(ModelConfig, flat canonical specs) of a preset's llama model at tp
    1, built on the meta device (shapes only)."""
    import torch

    from ..config import model_preset
    from ..models.transformer import Transformer
    from .layout import canonical_specs

    cfg = model_preset(preset)
    with torch.device("meta"):
        model = Transformer(cfg)
    return cfg, canonical_specs({k: v.shape
                                 for k, v in model.state_dict().items()})


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ..training.checkpoint import latest_step, validate_checkpoint
    from .apply import HostMeter, plan_checkpoint, reshard_checkpoint
    from .layout import make_layout, resolve_source_layout

    step = args.iter
    if step is None:
        if args.ext == "pth":
            raise SystemExit("--ext pth needs an explicit --iter (only "
                             "npz checkpoints index by latest_step)")
        step = latest_step(args.src)
        if step is None:
            raise SystemExit(f"no checkpoints found in {args.src}")

    specs = cfg = dst_specs = None
    if args.model:
        cfg, specs = model_specs(args.model)
        dst_specs = specs
    echo = lambda *a: print(*a, file=sys.stderr)
    if dst_specs is None:
        # a stamped source: the target takes the stamped spec tree (its
        # axis names hold at any mesh size)
        src_layout, _ = resolve_source_layout(args.src, step, specs=specs,
                                              ext=args.ext, echo=echo)
        dst_specs = src_layout.specs
    dst_layout = make_layout((("dp", args.dp), ("tp", args.tp)), dst_specs,
                             zero_stage=args.zero)

    if args.plan_only:
        plan, _, legacy = plan_checkpoint(args.src, step, dst_layout,
                                          specs=specs, ext=args.ext,
                                          cfg=cfg, echo=echo)
        rec = {"metric": "reshard_ckpt --plan_only", "value": 0,
               "unit": "bytes moved (planned)", **plan.summary(),
               "legacy": bool(legacy), "iter": step}
        rec["value"] = rec["bytes_moved"]
    else:
        meter = HostMeter()
        paths, _, info = reshard_checkpoint(
            args.src, step, args.dst, dst_layout, specs=specs, ext=args.ext,
            cfg=cfg, meter=meter, echo=echo)
        tp_out, _ = validate_checkpoint(args.dst, step)
        if tp_out != args.tp:
            raise SystemExit(f"wrote {tp_out} rank files, not --tp "
                             f"{args.tp}")
        rec = {"metric": "reshard_ckpt", "value": info["bytes_moved"],
               "unit": "bytes moved", **info, "iter": step,
               "files": len(paths)}
        echo(f"reshard {info['src']} -> {info['dst']}: {len(paths)} "
             f"shard(s) in {args.dst}, {info['bytes_moved']} bytes "
             f"moved, peak host {info['peak_host_bytes']} B, "
             f"{info['wall_ms']} ms")
    rec.update(run_stamp(vars(args)))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
