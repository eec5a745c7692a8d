"""The gpt2 family over its full vocabulary (50257 ids, the tied head and
the final LayerNorm at full width) trained with the recipe whose loss rose
on the card: a bigram rule over ALL ids (`chip_smoke.write_bigram_corpus`
with `rule_vocab=0`, here inline), lr 1e-3 after a 5-step warmup, 20 Adam
steps. At reduced depth and width (2 layers, d 64, b 4 x t 32) in float32
the port's train step and the JAX package's, from the same weights on the
same batches, give every step's loss within 1e-4 relative, and in both the
loss stays at the unigram level ln(50254) (within 0.2): the rule's rows
are too many to be learned in 20 steps, so the loss moves with the batch,
alike in both; what the recipe does to the loss is the recipe's, not the
port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig,
    OptimizerConfig as JOptimizerConfig)
from distributed_pytorch_from_scratch_tpu.models.gpt2 import (
    GPT2Transformer as JGPT2)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.training import optim as joptim
from distributed_pytorch_from_scratch_tpu.training import (
    train_step as jtrain_step)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    ModelConfig, OptimizerConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models.gpt2 import (
    GPT2Transformer)
from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
    init_adam_state)
from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
    build_train_step)
from _torch_threads import two_torch_threads  # noqa: F401


VOCAB = 50257
CFG = dict(attn_dim=64, ffn_dim=256, num_heads=2, num_layers=2,
           vocab_size=VOCAB, maxlen=32, compute_dtype="float32")
# the recipe's optimizer: the train CLI's `--lr 1e-3 --warmup_steps 5
# --max_steps 20` (OneCycle, no clipping)
ADAM = dict(lr=1e-3, warmup_steps=5, max_steps=20)
STEPS, B, T = 20, 4, 32


def _bigram_batches(seed=0):
    """(ids, targets, positions), each (STEPS, B, T): every row a run of
    T + 1 tokens under one bigram rule over ids 3..VOCAB-1 (next =
    perm[prev], the rule `chip_smoke.write_bigram_corpus` draws), from a
    random first token."""
    rng = np.random.default_rng(seed)
    nxt = np.zeros(VOCAB, np.int64)
    nxt[3:] = rng.permutation(np.arange(3, VOCAB))
    chains = np.empty((STEPS, B, T + 1), np.int64)
    chains[..., 0] = rng.integers(3, VOCAB, size=(STEPS, B))
    for i in range(1, T + 1):
        chains[..., i] = nxt[chains[..., i - 1]]
    pos = np.broadcast_to(np.arange(T), (STEPS, B, T))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (chains[..., :-1], chains[..., 1:], pos)]


def test_full_vocab_bigram_losses_match_jax_step_for_step():
    batches = _bigram_batches()
    jm = JGPT2(JModelConfig(**CFG))
    mesh = jmake_mesh(JMeshConfig())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    jstep = jtrain_step.build_train_step(jm, mesh, JOptimizerConfig(**ADAM),
                                         with_grad_norm=True)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jm.shardings(mesh))
    state = joptim.init_adam_state(params)
    ref = []
    for i in range(STEPS):
        params, state, (loss, _) = jstep(params, state,
                                         *(x[i] for x in batches))
        ref.append(float(loss))

    model = GPT2Transformer(ModelConfig(**CFG))
    model.load_state_dict(params_from_jax(tree))
    step = build_train_step(model, OptimizerConfig(**ADAM))
    opt = init_adam_state(dict(model.named_parameters()))
    got = []
    for i in range(STEPS):
        loss, _, opt = step(opt, *(torch.from_numpy(x[i]).long()
                                   for x in batches))
        got.append(loss.item())
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # no bigram row repeats often enough in 20 steps to be learned: the
    # loss stays at the unigram level of the rule's 50254 ids
    assert np.abs(np.array(ref) - np.log(VOCAB - 3)).max() < 0.2, ref
