"""Shared CLI plumbing for the inference-side entry points: the model-shape
flag block and the preset-aware ModelConfig assembly (a copy of the JAX
package's `cli.py`, so both packages parse the same flags)."""

from __future__ import annotations

import argparse

from .config import MODEL_PRESETS, ModelConfig, model_preset


def add_model_shape_args(g: argparse._ArgumentGroup) -> None:
    """The shape flags a checkpoint-consuming CLI needs (must match the
    trained model; presets give the defaults)."""
    g.add_argument("--model", choices=sorted(MODEL_PRESETS), default=None,
                   help="named shape preset; must match the trained model "
                        "(explicit dim flags override preset fields)")
    g.add_argument("--attn_dim", type=int, default=None)
    g.add_argument("--ffn_dim", type=int, default=None)
    g.add_argument("--num_heads", type=int, default=None)
    g.add_argument("--num_kv_heads", type=int, default=None,
                   help="must match the trained model (GQA, llama family)")
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--maxlen", type=int, default=None)
    g.add_argument("--num_experts", type=int, default=None,
                   help="MoE checkpoint shape (must match training)")
    g.add_argument("--moe_top_k", type=int, default=None)
    g.add_argument("--moe_capacity_factor", type=float, default=None)
    g.add_argument("--bf16", action="store_true", default=True)
    g.add_argument("--no-bf16", dest="bf16", action="store_false")


def build_model_config(args: argparse.Namespace,
                       vocab_size: int) -> ModelConfig:
    """Preset-aware ModelConfig from the shared shape flags."""
    preset = model_preset(args.model) if args.model else ModelConfig()
    pick = lambda flag, dflt: dflt if flag is None else flag
    return ModelConfig(
        attn_dim=pick(args.attn_dim, preset.attn_dim),
        ffn_dim=pick(args.ffn_dim, preset.ffn_dim),
        num_heads=pick(args.num_heads, preset.num_heads),
        num_kv_heads=pick(args.num_kv_heads, preset.num_kv_heads),
        num_layers=pick(args.num_layers, preset.num_layers),
        num_experts=pick(args.num_experts, preset.num_experts),
        moe_top_k=pick(args.moe_top_k, preset.moe_top_k),
        moe_capacity_factor=pick(args.moe_capacity_factor,
                                 preset.moe_capacity_factor),
        vocab_size=vocab_size,
        maxlen=pick(args.maxlen, preset.maxlen),
        compute_dtype="bfloat16" if args.bf16 else "float32")
