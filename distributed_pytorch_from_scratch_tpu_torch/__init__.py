"""PyTorch/CUDA port of `distributed_pytorch_from_scratch_tpu`.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's layout and math, and the tests (`tests/test_torch_*.py`)
hold each one against the JAX function on the same inputs. The port imports
torch and numpy only — never jax and never the JAX package.

Ported so far, for the llama family at tp=1: the slot-engine serving path
(`serving/serve.py`) and single-device training (`train.py`), with the
causal flash attention — forward, and the backward's dq and dk/dv — as
CUDA kernels for Hopper (`ops/cuda/`). See ROADMAP.md for what is still
to come.
"""

__version__ = "0.1.0"
