"""FineWeb parquet -> {train, validation} text JSON — the port's copy of
the JAX `data/preprocess.py`, with the same semantics and a byte-identical
output file (`{"train": [str], "validation": [str]}`), so files produced
by either package (or the source repo's `preprocess_data.py`)
interoperate:

* keep texts with <= `max_chars` characters (the source repo filters at
  2000);
* shuffle with `random.Random(seed)`;
* split `val_ratio` (the source repo: 1%) into validation, the rest into
  train.

    python -m distributed_pytorch_from_scratch_tpu_torch.data.preprocess \\
        -i train-00000.parquet -o texts.json

`pandas` (and its parquet engine) is imported inside `preprocess`, so the
module imports on a machine without them.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import List


def preprocess(parquet_path: str, output_path: str, max_chars: int = 2000,
               val_ratio: float = 0.01, seed: int = 0) -> dict:
    import pandas as pd  # host-side only

    df = pd.read_parquet(parquet_path)
    texts: List[str] = [t for t in df["text"].tolist() if len(t) <= max_chars]
    rng = random.Random(seed)
    rng.shuffle(texts)
    n_val = max(1, int(len(texts) * val_ratio))
    data = {"train": texts[n_val:], "validation": texts[:n_val]}
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(data, f)
    print(f"preprocess: {len(data['train'])} train / {len(data['validation'])} "
          f"validation texts -> {output_path}")
    return data


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parquet_path", "-i", required=True)
    p.add_argument("--output_path", "-o", required=True)
    p.add_argument("--max_chars", type=int, default=2000)
    p.add_argument("--val_ratio", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    preprocess(args.parquet_path, args.output_path, args.max_chars,
               args.val_ratio, args.seed)


if __name__ == "__main__":
    main()
