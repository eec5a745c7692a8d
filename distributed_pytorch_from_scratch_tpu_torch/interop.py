"""Weight exchange with the JAX package and with the source repo.

`params_from_jax` maps a JAX param tree of either family (as numpy
arrays: the tree `Transformer.init` or `GPT2Transformer.init` returns, or
a checkpoint's params; the family shows in the tree: llama has an
`lm_head`, gpt2 a `pos_embedding`, LayerNorm biases and a tied head) onto
the port's model `state_dict()`, whole or one tp rank's shard of it;
`params_to_jax` is its inverse, and `shards_to_jax` assembles every tp
rank's shard into the global tree. The JAX tree stacks every per-layer
leaf on a leading num_layers axis and keeps linear weights as (idim,
odim); the port has one module per layer and torch's (odim, idim) layout,
so layers are unstacked and linear weights transposed. This is what lets
the tests feed both packages the same weights. `adam_state_from_jax`/
`adam_state_to_jax` carry the Adam moments the same way: they are trees of
the param layout.

Each leaf shards over tp on the dim its JAX spec (`Transformer.specs()`)
marks as 'tp', seen in torch's layout (`parallel.layout`, which also pads
a vocab that does not divide by tp with zero rows and columns, as the JAX
init pads its table and head).

**The source repo's `.pth` checkpoints** (the JAX `interop.py`, both
directions). The source repo saves one torch `state_dict` per tp rank as
`tprank-{r}_iter-{n}_loss-{x}.pth`, holding that rank's shards of the
Megatron-partitioned weights:

    embedding.weight                 (vocab/tp, d)   row shard
    layers.{i}.attn.{wq,wk,wv}.weight  (d/tp, d)     column shard (+ bias (d/tp,))
    layers.{i}.attn.wo.weight        (d, d/tp)       row shard    (+ bias (d,) replicated)
    layers.{i}.ffn.{gate,up}_proj.weight (f/tp, d)   column shard (+ bias (f/tp,))
    layers.{i}.ffn.down_proj.weight  (d, f/tp)       row shard    (+ bias (d,) replicated)
    layers.{i}.norm{1,2}.scale       (d,)            replicated
    norm.scale                       (d,)            replicated
    lm_head.weight                   (vocab/tp, d)   column shard (+ bias (vocab/tp,))

`convert_state_dicts` reassembles the global tensors from every rank's
dict into the JAX param tree (stacked layers, (idim, odim) weights, the
vocab zero-padded to a multiple of `pad_vocab_multiple`), the same arrays
bit for bit as the JAX function; `export_state_dicts` is its inverse (the
padding dropped) at any tp that divides the shapes. The CLI writes an
import as a checkpoint in the JAX npz format (`training/checkpoint
.save_checkpoint`, which both packages read), and exports any checkpoint
the port reads:

    # source repo -> npz checkpoint
    python -m distributed_pytorch_from_scratch_tpu_torch.interop \
        --ref_ckpt_dir <dir with tprank-*.pth> --iter 16000 \
        --out_dir <checkpoint dir> \
        --attn_dim 512 --ffn_dim 2048 --num_heads 8 --num_layers 12 \
        --vocab_size 1024 --maxlen 1000
    # npz checkpoint -> source repo (any tp that divides the shapes)
    python -m distributed_pytorch_from_scratch_tpu_torch.interop \
        --direction export --our_ckpt_dir <dir with tprank-*.npz> \
        --export_tp 4 --out_dir <reference checkpoint dir> [shape flags]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import re
from typing import Any, Dict, List

import numpy as np
import torch

from .config import ModelConfig
from .parallel.layout import Tensors, assemble_params, shard_params
from .training.optim import AdamState

# per-layer modules whose "weight" is a linear (idim, odim) matrix in JAX
_LINEARS = ("wq", "wk", "wv", "wo", "gate_proj", "up_proj", "down_proj",
            "fc", "proj")


def tree_family(tree: Dict[str, Any]) -> str:
    """'llama' (the tree has an lm_head) or 'gpt2' (its head is tied)."""
    return "llama" if "lm_head" in tree else "gpt2"



def params_from_jax(tree: Dict[str, Any], tp_size: int = 1,
                    tp_rank: int = 0, ep_size: int = 1,
                    ep_rank: int = 0) -> Tensors:
    """JAX param tree (nested dicts of numpy arrays) -> torch state_dict:
    the whole of it at tp_size = ep_size = 1, else the shard of rank
    (tp_rank, ep_rank). A MoE layer's `moe` subtree (the JAX stacked (L, E,
    ...) leaves) maps leaf for leaf, untransposed."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {"embedding.weight": t(tree["embedding"]["weight"])}
    if "pos_embedding" in tree:
        sd["pos_embedding.weight"] = t(tree["pos_embedding"]["weight"])
    sd.update({f"norm.{leaf}": t(arr) for leaf, arr in tree["norm"].items()})
    if "lm_head" in tree:
        sd["lm_head.weight"] = t(tree["lm_head"]["weight"]).T.contiguous()
        sd["lm_head.bias"] = t(tree["lm_head"]["bias"])
    layers = tree["layers"]
    num_layers = np.shape(layers["wq"]["weight"])[0]
    for i in range(num_layers):
        for name, leaves in layers.items():
            for leaf, arr in leaves.items():
                val = t(np.asarray(arr)[i])
                if name in _LINEARS and leaf == "weight":
                    val = val.T.contiguous()
                sd[f"layers.{i}.{name}.{leaf}"] = val
    return shard_params(sd, tp_size, tp_rank, ep_size, ep_rank)


def params_to_jax(state_dict: Tensors) -> Dict[str, Any]:
    """Inverse of `params_from_jax` at tp 1: torch state_dict -> JAX param
    tree of numpy float32 arrays, layers stacked on a leading axis. Given
    one tp rank's shard, it gives that rank's slice of every JAX leaf (the
    leaves of a JAX shard file)."""
    n = lambda x: x.detach().cpu().float().numpy()
    tree: Dict[str, Any] = {
        "embedding": {"weight": n(state_dict["embedding.weight"])},
        "norm": {leaf: n(state_dict[f"norm.{leaf}"])
                 for leaf in ("scale", "bias")
                 if f"norm.{leaf}" in state_dict},
    }
    if "pos_embedding.weight" in state_dict:
        tree["pos_embedding"] = {
            "weight": n(state_dict["pos_embedding.weight"])}
    if "lm_head.weight" in state_dict:
        tree["lm_head"] = {"weight": n(state_dict["lm_head.weight"]).T.copy(),
                           "bias": n(state_dict["lm_head.bias"])}
    per_layer: Dict[str, Dict[str, Dict[int, np.ndarray]]] = {}
    for key, val in state_dict.items():
        if not key.startswith("layers."):
            continue
        _, i, name, leaf = key.split(".")
        arr = n(val)
        if name in _LINEARS and leaf == "weight":
            arr = arr.T.copy()
        per_layer.setdefault(name, {}).setdefault(leaf, {})[int(i)] = arr
    tree["layers"] = {
        name: {leaf: np.stack([by_i[i] for i in sorted(by_i)])
               for leaf, by_i in leaves.items()}
        for name, leaves in per_layer.items()}
    return tree


def shards_to_jax(shards: List[Tensors], ep_size: int = 1
                  ) -> Dict[str, Any]:
    """Every rank's shard, in rank order (ep major, tp minor) -> the global
    JAX param tree."""
    return params_to_jax(assemble_params(shards, ep_size))


def adam_state_from_jax(state: Any) -> AdamState:
    """A JAX `AdamState` (anything with `step`, `mu`, `nu`; trees of numpy
    arrays) -> the port's AdamState."""
    return AdamState(step=int(np.asarray(state.step)),
                     mu=params_from_jax(state.mu),
                     nu=params_from_jax(state.nu))


def adam_state_to_jax(state: AdamState) -> Dict[str, Any]:
    """The port's AdamState -> {"step", "mu", "nu"} in the JAX layout
    (`AdamState(**adam_state_to_jax(s))` on the JAX side)."""
    return {"step": np.asarray(state.step, np.int32),
            "mu": params_to_jax(state.mu), "nu": params_to_jax(state.nu)}


# -- the source repo's per-rank .pth checkpoints ---------------------------

PTH_RE = re.compile(r"tprank-(\d+)_iter-(\d+)_loss-(.+?)\.pth$")


def find_reference_shards(ckpt_dir: str, step: int) -> List[str]:
    """Per-rank .pth paths for iteration `step`, ordered by rank. A hole in
    the rank set (ranks 0..max present) is refused by name, before any
    assembly (the JAX `validate_checkpoint` for .pth files)."""
    by_rank: Dict[int, str] = {}
    for p in glob.glob(os.path.join(ckpt_dir,
                                    f"tprank-*_iter-{step}_loss-*.pth")):
        m = PTH_RE.search(os.path.basename(p))
        if m and int(m.group(2)) == step:
            by_rank[int(m.group(1))] = p
    if not by_rank:
        raise FileNotFoundError(f"no checkpoint for iter {step} in "
                                f"{ckpt_dir}")
    tp_size = max(by_rank) + 1
    missing = sorted(set(range(tp_size)) - set(by_rank))
    if missing:
        raise FileNotFoundError(
            f"checkpoint iter {step} was written with tp_size={tp_size} but "
            f"shard files for rank(s) {missing} are missing from {ckpt_dir} "
            f"— restore the missing rank file(s) or re-save the checkpoint")
    return [by_rank[r] for r in range(tp_size)]


def reference_iters(ckpt_dir: str) -> List[int]:
    its = set()
    for p in glob.glob(os.path.join(ckpt_dir, "tprank-*_iter-*_loss-*.pth")):
        m = PTH_RE.search(os.path.basename(p))
        if m:
            its.add(int(m.group(2)))
    return sorted(its)


def convert_state_dicts(shards: List[Dict[str, np.ndarray]],
                        cfg: ModelConfig,
                        pad_vocab_multiple: int = 1) -> Dict:
    """Per-rank source-repo state_dicts (numpy values) -> the JAX global
    param tree (numpy), the JAX `convert_state_dicts`.

    `pad_vocab_multiple`: zero-pad the vocab rows/cols of the embedding
    and lm_head up to a multiple of this value (a checkpoint loads at a tp
    only when its vocab rows divide by that tp; a vocab that divides —
    e.g. 1024 — needs no padding for any practical tp)."""
    if "lm_head.weight" not in shards[0] or any(
            k.startswith("pos_embedding.") for k in shards[0]):
        raise ValueError(
            "these state_dicts hold a gpt2 tree (a tied head or learned "
            "positions): the source repo's .pth format is the llama "
            "family's only, and the gpt2 family has no .pth form")
    L = cfg.num_layers
    m = max(1, pad_vocab_multiple)
    vp = ((cfg.vocab_size + m - 1) // m) * m

    def cat(key: str, dim: int) -> np.ndarray:
        return np.concatenate([s[key] for s in shards], axis=dim)

    def col_linear(prefix: str) -> Dict[str, np.ndarray]:
        # torch column shards (odim/tp, idim) -> global (odim, idim) ->
        # (idim, odim); bias shards (odim/tp,) -> (odim,)
        out = {"weight": np.ascontiguousarray(cat(f"{prefix}.weight", 0).T)}
        if f"{prefix}.bias" in shards[0]:
            out["bias"] = cat(f"{prefix}.bias", 0)
        return out

    def row_linear(prefix: str) -> Dict[str, np.ndarray]:
        # torch row shards (odim, idim/tp) -> global (odim, idim) ->
        # (idim, odim); bias replicated -> rank 0's copy
        out = {"weight": np.ascontiguousarray(cat(f"{prefix}.weight", 1).T)}
        if f"{prefix}.bias" in shards[0]:
            out["bias"] = shards[0][f"{prefix}.bias"]
        return out

    def pad_rows(w: np.ndarray) -> np.ndarray:
        if w.shape[0] == vp:
            return w
        return np.concatenate(
            [w, np.zeros((vp - w.shape[0],) + w.shape[1:], w.dtype)], axis=0)

    raw = cat("embedding.weight", 0)
    # an exact match BEFORE padding: an over-declared --vocab_size would
    # otherwise be zero-filled into "real" vocab rows
    if raw.shape != (cfg.vocab_size, cfg.attn_dim):
        raise ValueError(f"embedding reassembled to {raw.shape}; expected "
                         f"({cfg.vocab_size}, {cfg.attn_dim}) — do the "
                         f"--attn_dim/--vocab_size flags match the trained "
                         f"model?")
    emb = pad_rows(raw)

    def one_layer(i: int) -> Dict:
        p = f"layers.{i}"
        return {
            "wq": col_linear(f"{p}.attn.wq"),
            "wk": col_linear(f"{p}.attn.wk"),
            "wv": col_linear(f"{p}.attn.wv"),
            "wo": row_linear(f"{p}.attn.wo"),
            "gate_proj": col_linear(f"{p}.ffn.gate_proj"),
            "up_proj": col_linear(f"{p}.ffn.up_proj"),
            "down_proj": row_linear(f"{p}.ffn.down_proj"),
            "norm1": {"scale": shards[0][f"{p}.norm1.scale"]},
            "norm2": {"scale": shards[0][f"{p}.norm2.scale"]},
        }

    layers = [one_layer(i) for i in range(L)]
    stacked = {mod: {k: np.stack([lyr[mod][k] for lyr in layers])
                     for k in layers[0][mod]}
               for mod in layers[0]}

    lm = col_linear("lm_head")
    if lm["weight"].shape != (cfg.attn_dim, cfg.vocab_size):
        raise ValueError(f"lm_head reassembled to {lm['weight'].shape}; "
                         f"expected ({cfg.attn_dim}, {cfg.vocab_size})")
    lm["weight"] = np.concatenate(
        [lm["weight"],
         np.zeros((cfg.attn_dim, vp - lm["weight"].shape[1]),
                  lm["weight"].dtype)], axis=1)
    if "bias" in lm:
        lm["bias"] = pad_rows(lm["bias"])

    return {
        "embedding": {"weight": emb},
        "layers": stacked,
        "norm": {"scale": shards[0]["norm.scale"]},
        "lm_head": lm,
    }


def load_reference_checkpoint(ckpt_dir: str, step: int, cfg: ModelConfig,
                              pad_vocab_multiple: int = 1) -> Dict:
    """The .pth rank shards of iteration `step` -> the JAX param tree (f32
    numpy)."""
    shards = []
    for path in find_reference_shards(ckpt_dir, step):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        shards.append({k: v.float().numpy() for k, v in sd.items()})
    return convert_state_dicts(shards, cfg, pad_vocab_multiple)


def export_state_dicts(params: Dict, cfg: ModelConfig,
                       tp: int) -> List[Dict[str, np.ndarray]]:
    """The JAX param tree -> per-rank source-repo state_dicts: the inverse
    of `convert_state_dicts` (the JAX `export_state_dicts`). Only what the
    source repo can express exports: MHA (no GQA), a dense FFN (no MoE),
    and a tp that divides the vocab, heads and widths, as its layers
    require. Vocab padding rows/cols are dropped. A gpt2 tree is refused
    by its family's name."""
    if tree_family(params) != "llama":
        raise ValueError(
            f"a {tree_family(params)} checkpoint has no .pth form: the "
            f"source repo implements the llama family only (RoPE/RMSNorm/"
            f"SwiGLU with an lm_head)")
    L, V, d = cfg.num_layers, cfg.vocab_size, cfg.attn_dim
    if cfg.num_experts:
        raise ValueError("MoE checkpoints cannot export: the reference's "
                         "FFN is dense (no router/experts)")
    if cfg.kv_heads != cfg.num_heads:
        raise ValueError("GQA checkpoints cannot export: the reference is "
                         "MHA-only (num_kv_heads == num_heads)")
    if tp < 1:
        raise ValueError(f"export tp must be >= 1, got {tp}")
    for what, size in [("vocab_size", V), ("num_heads", cfg.num_heads),
                       ("attn_dim", d), ("ffn_dim", cfg.ffn_dim)]:
        if size % tp != 0:
            raise ValueError(f"tp {tp} must divide {what} {size} for the "
                             f"reference's partitioning")
    np_ = lambda a: np.asarray(a, np.float32)

    # the tree against the declared shape BEFORE slicing: understated flags
    # would otherwise truncate the model silently
    emb_rows = np.shape(params["embedding"]["weight"])[0]
    got_L = np.shape(params["layers"]["wq"]["weight"])[0]
    got_d = np.shape(params["norm"]["scale"])[0]
    got_f = np.shape(params["layers"]["down_proj"]["weight"])[1]
    if got_L != L or got_d != d or got_f != cfg.ffn_dim:
        raise ValueError(
            f"checkpoint shape (layers={got_L}, attn_dim={got_d}, "
            f"ffn_dim={got_f}) does not match the declared flags "
            f"(layers={L}, attn_dim={d}, ffn_dim={cfg.ffn_dim})")
    if emb_rows < V:
        raise ValueError(
            f"checkpoint embedding has only {emb_rows} vocab rows but "
            f"--vocab_size is {V} — the flag overstates the trained vocab")
    if emb_rows >= V + 64:
        # padding is < the training tp degree (<= 64 in practice); a larger
        # gap means --vocab_size understates the trained vocab
        raise ValueError(
            f"checkpoint embedding has {emb_rows} vocab rows but "
            f"--vocab_size is {V}; exporting would silently drop "
            f"{emb_rows - V} real rows — do the flags match the trained "
            f"model?")

    def col_shards(w, b, r, unpad_to=None):
        # (idim, odim[+pad]) -> torch (odim, idim) shard r over dim 0;
        # `unpad_to` drops the padded output rows (lm_head only)
        wt = np_(w).T
        if unpad_to is not None:
            wt = wt[:unpad_to]
        out = {"weight": np.ascontiguousarray(np.split(wt, tp, axis=0)[r])}
        if b is not None:
            bb = np_(b)
            if unpad_to is not None:
                bb = bb[:unpad_to]
            out["bias"] = np.split(bb, tp, axis=0)[r]
        return out

    def row_shards(w, b, r):
        wt = np_(w).T
        out = {"weight": np.ascontiguousarray(np.split(wt, tp, axis=1)[r])}
        if b is not None:
            out["bias"] = np_(b)  # replicated full bias
        return out

    lyr = params["layers"]
    get = lambda mod, k, i: lyr[mod][k][i] if k in lyr[mod] else None
    shards = []
    for r in range(tp):
        sd: Dict[str, np.ndarray] = {
            "embedding.weight": np.split(
                np_(params["embedding"]["weight"])[:V], tp, axis=0)[r],
            "norm.scale": np_(params["norm"]["scale"]),
        }
        sd.update({f"lm_head.{k}": v for k, v in col_shards(
            params["lm_head"]["weight"],
            params["lm_head"].get("bias"), r, unpad_to=V).items()})
        for i in range(L):
            p = f"layers.{i}"
            for mod, ref, kind in [("wq", "attn.wq", "col"),
                                   ("wk", "attn.wk", "col"),
                                   ("wv", "attn.wv", "col"),
                                   ("wo", "attn.wo", "row"),
                                   ("gate_proj", "ffn.gate_proj", "col"),
                                   ("up_proj", "ffn.up_proj", "col"),
                                   ("down_proj", "ffn.down_proj", "row")]:
                fn = col_shards if kind == "col" else row_shards
                for k, v in fn(lyr[mod]["weight"][i],
                               get(mod, "bias", i), r).items():
                    sd[f"{p}.{ref}.{k}"] = v
            sd[f"{p}.norm1.scale"] = np_(lyr["norm1"]["scale"][i])
            sd[f"{p}.norm2.scale"] = np_(lyr["norm2"]["scale"][i])
        shards.append(sd)
    return shards


def export_reference_checkpoint(params: Dict, cfg: ModelConfig, tp: int,
                                out_dir: str, step: int,
                                loss: float = 0.0) -> List[str]:
    """Write per-rank `tprank-{r}_iter-{step}_loss-{loss:.4f}.pth` files,
    the names the source repo's `test.py` finds."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for r, sd in enumerate(export_state_dicts(params, cfg, tp)):
        path = os.path.join(out_dir,
                            f"tprank-{r}_iter-{step}_loss-{loss:.4f}.pth")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}, path)
        paths.append(path)
    return paths


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def main(argv=None) -> Dict:
    """The CLI (see the module docstring); returns the params tree it
    converted."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--direction", choices=["import", "export"],
                   default="import",
                   help="'import' = source-repo .pth -> npz checkpoint; "
                        "'export' = npz checkpoint -> source-repo .pth")
    p.add_argument("--ref_ckpt_dir", default=None,
                   help="import: directory holding the tprank-*.pth files")
    p.add_argument("--our_ckpt_dir", default=None,
                   help="export: directory holding the tprank-*.npz "
                        "checkpoint (either package's, any tp)")
    p.add_argument("--export_tp", type=int, default=1,
                   help="export: how many .pth rank files to write")
    p.add_argument("--iter", type=int, default=None,
                   help="iteration to convert (default: latest found)")
    p.add_argument("--out_dir", required=True,
                   help="output directory for the converted checkpoint")
    p.add_argument("--attn_dim", type=int, default=512)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--vocab_size", type=int, default=1024)
    p.add_argument("--maxlen", type=int, default=1000)
    p.add_argument("--pad_vocab_multiple", type=int, default=1,
                   help="zero-pad the vocab dim to a multiple of this (your "
                        "target tp degree when vocab_size does not divide "
                        "it)")
    args = p.parse_args(argv)

    from .models.transformer import Transformer
    from .training.checkpoint import (CKPT_RE, find_rank_shards,
                                      latest_step, load_checkpoint,
                                      save_checkpoint)

    cfg = ModelConfig(attn_dim=args.attn_dim, ffn_dim=args.ffn_dim,
                      num_heads=args.num_heads, num_layers=args.num_layers,
                      vocab_size=args.vocab_size, maxlen=args.maxlen)

    if args.direction == "export":
        if not args.our_ckpt_dir:
            raise SystemExit("--direction export needs --our_ckpt_dir")
        step = args.iter
        if step is None:
            step = latest_step(args.our_ckpt_dir)
            if step is None:
                raise SystemExit(f"no checkpoints in {args.our_ckpt_dir}")
        state, _, _ = load_checkpoint(args.our_ckpt_dir, step)
        params = params_to_jax(state)
        # carry the loss in our file name into the exported names
        src = find_rank_shards(args.our_ckpt_dir, step)
        m = CKPT_RE.search(os.path.basename(src[min(src)]))
        try:
            loss = float(m.group(3)) if m else 0.0
        except ValueError:
            loss = 0.0
        if math.isnan(loss):  # e.g. an imported checkpoint's 'loss-nan'
            loss = 0.0
        paths = export_reference_checkpoint(params, cfg, args.export_tp,
                                            args.out_dir, step, loss=loss)
        print(f"exported iter {step} -> {len(paths)} reference rank "
              f"file(s), first: {paths[0]}")
        return params

    if not args.ref_ckpt_dir:
        raise SystemExit("--direction import needs --ref_ckpt_dir")
    step = args.iter
    if step is None:
        its = reference_iters(args.ref_ckpt_dir)
        if not its:
            raise SystemExit(f"no reference checkpoints in "
                             f"{args.ref_ckpt_dir}")
        step = its[-1]
    params = load_reference_checkpoint(args.ref_ckpt_dir, step, cfg,
                                       args.pad_vocab_multiple)
    # the tree against a model of the padded vocab's shapes, before
    # anything is written
    vp = cfg.padded_vocab_size(max(1, args.pad_vocab_multiple))
    template = params_to_jax(Transformer(ModelConfig(
        attn_dim=cfg.attn_dim, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads,
        num_layers=cfg.num_layers, vocab_size=vp,
        maxlen=cfg.maxlen)).state_dict())
    flat_t = {"/".join(map(str, path)): leaf for path, leaf in
              _walk(template)}
    flat_p = {"/".join(map(str, path)): leaf for path, leaf in _walk(params)}
    if set(flat_t) != set(flat_p):
        raise SystemExit(f"converted tree mismatch: missing "
                         f"{sorted(set(flat_t) - set(flat_p))}, extra "
                         f"{sorted(set(flat_p) - set(flat_t))}")
    for k in flat_t:
        if tuple(flat_t[k].shape) != tuple(flat_p[k].shape):
            raise SystemExit(f"shape mismatch at {k}: reference gives "
                             f"{flat_p[k].shape}, model expects "
                             f"{flat_t[k].shape}")
    paths = save_checkpoint(args.out_dir, step, float("nan"),
                            params_from_jax(params), tp_size=1)
    print(f"imported reference iter {step} "
          f"({len(find_reference_shards(args.ref_ckpt_dir, step))} rank "
          f"shard(s)) -> {paths[0]}")
    return params


if __name__ == "__main__":
    main()
