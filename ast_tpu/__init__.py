"""ast_tpu — a JAX/XLA speech-to-text framework.

A from-scratch rebuild of the capabilities of the 0xSameer/ast research
harness (pyramidal CNN -> BiLSTM encoder, Luong-attention LSTM decoder,
Fisher es->en speech translation + GlobalPhone ASR pretraining), built
for an accelerator through plain XLA:

- functional core: pytree params, pure ``loss_fn(params, state, batch, rng)``
- ``jax.lax.scan`` recurrences instead of per-timestep Python loops
- static bucketed shapes so XLA compiles a bounded set of programs
- batched on-device greedy + beam decoding (``lax.while_loop`` / ``lax.top_k``)
- data-parallel training over a ``jax.sharding.Mesh`` (XLA all-reduce)
- on-device MFCC/fbank + CMVN feature extraction (matmul DFT)

External contracts (experiment dir layout, config JSON schema, SYMBOLS ids,
log formats, checkpoint-per-epoch resume, refs/BLEU protocol) match the
reference so existing experiment recipes run unchanged.
"""

from ast_tpu.symbols import SYMBOLS
from ast_tpu.config import Config

__version__ = "0.1.0"

__all__ = ["SYMBOLS", "Config", "__version__"]
